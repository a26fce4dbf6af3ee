"""allreduce_ms.dp4: device milliseconds of rank 0's ``gradient all-reduce``
span (``train/state.py::train_step`` under ``parallel/mesh.py``'s
``make_train_step``: the trainable gradients concatenated, summed across
the ranks in one all-reduce, and copied back), from the stream reaching
the span's entry event to its exit event; the mean over the traced
slice's steps."""

from benchmark.harness import stages


def read(run):
    return stages.mean_ms(run, stages.TRAIN, ("gradient all-reduce",))

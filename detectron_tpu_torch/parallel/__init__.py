"""Data parallelism over ``torch.distributed`` (``parallel/mesh.py``)."""

from detectron_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    broadcast_state,
    data_parallel,
    global_sum,
    initialize_distributed,
    join_group,
    make_mesh,
    make_predict_step,
    make_train_step,
    rank_rows,
    shard_batch,
)

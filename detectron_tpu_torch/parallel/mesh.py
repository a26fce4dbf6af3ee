"""Data parallelism over ``torch.distributed``.

The port of ``detectron_tpu/parallel/mesh.py``. JAX compiles one SPMD
program over a batch sharded across its devices; here every process (a
"rank") holds a replica of the detector on its own device and its rows of
the global batch, and collectives join them:

* :func:`initialize_distributed` starts the process group (NCCL on the
  card, gloo on the CPU) from the ``parallel.*`` keys or from torchrun's
  environment; :func:`make_mesh` gives the rank's :class:`Mesh`;
* :func:`shard_batch` takes a rank's rows of a global batch;
* :func:`make_train_step` is the data-parallel step. It equals one
  process's step on the global batch, as JAX's single program does: each
  loss divides its rank's numerator by the normalizer of the global batch
  (:func:`global_sum` inside the losses), the sampling draws are the
  global draws' rows (:func:`rank_rows`), and the gradients are summed
  across ranks, in one coalesced all-reduce, before the gradient clip, so
  that the clip sees the global norm. A plain average of per-rank
  gradients (DDP) would divide each rank's loss by its own normalizer
  instead;
* :func:`make_predict_step` runs the rank's rows of a global batch.

:func:`data_parallel` scopes the collectives: outside it :func:`global_sum`
and :func:`rank_rows` change nothing, and without a process group
:func:`global_sum` changes nothing either.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import NamedTuple

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """One rank's view of the data-parallel group: its index, the group's
    size, the rank's device and the process group (None: no group, one
    process)."""

    rank: int
    world: int
    device: torch.device
    group: object = None


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def local_rank(rank: int) -> int:
    """The rank's card on its host: torchrun's ``LOCAL_RANK``, else the rank
    modulo the host's card count."""
    local = _env_int("LOCAL_RANK")
    if local is not None:
        return local
    return rank % max(torch.cuda.device_count(), 1)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None, backend: str | None = None) -> tuple[int, int]:
    """Joins this process to the data-parallel group; call once per process
    before any use of the device. Returns ``(rank, world size)``.

    The group comes from the arguments (``parallel.coordinator_address``
    as ``host:port``, ``parallel.num_processes``, ``parallel.process_id``),
    else from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``); with neither it does
    nothing and returns ``(0, 1)``. An existing group is kept. ``device``:
    None for the card, where each rank runs on ``cuda:{LOCAL_RANK}`` and the
    backend is NCCL; ``"cpu"`` for gloo on the CPU. ``backend`` names
    another backend (gloo on the card, for several ranks on one card,
    which NCCL refuses). No CUDA, or no NCCL on the card, raises: there is
    no fallback."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("parallel.coordinator_address needs parallel.num_processes "
                             "and parallel.process_id")
        init_method, rank, world = f"tcp://{coordinator_address}", process_id, num_processes
    elif _env_int("WORLD_SIZE") is not None and os.environ.get("MASTER_ADDR"):
        init_method, rank, world = "env://", _env_int("RANK") or 0, _env_int("WORLD_SIZE")
    else:
        return 0, 1
    on_card = torch.device("cuda" if device is None else device).type == "cuda"
    if backend is None:
        backend = "nccl" if on_card else "gloo"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for gloo on the CPU")
        torch.cuda.set_device(local_rank(rank))
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this PyTorch has no NCCL: the card's data parallelism needs it")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return rank, world


def join_group(cfg, device=None) -> tuple[int, int]:
    """:func:`initialize_distributed` from the ``parallel.*`` keys of
    ``cfg`` (or torchrun's environment), as ``train.py`` and ``eval.py``
    call it: ``(rank, world size)``."""
    p = cfg.parallel
    return initialize_distributed(
        p.coordinator_address or None, p.num_processes or None,
        p.process_id if p.process_id >= 0 else None, device=device)


def make_mesh(device=None) -> Mesh:
    """This rank's :class:`Mesh`: the default process group if one is
    initialized (else one process, no group) and the rank's device
    (``cuda:{local rank}``, or the CPU with ``device="cpu"``)."""
    from detectron_tpu_torch.models import zoo

    if dist.is_available() and dist.is_initialized():
        rank, world, group = dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    else:
        rank, world, group = 0, 1, None
    dev = zoo.resolve_device(device)  # the card by default; raises without CUDA
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank(rank))
    return Mesh(rank, world, dev, group)


def shard_rows(total: int, mesh: Mesh) -> slice:
    """The rows of a global batch of ``total`` that ``mesh.rank`` holds:
    the ``total // world`` rows from ``rank * (total // world)``."""
    if total % mesh.world:
        raise ValueError(f"global batch {total} does not divide across {mesh.world} ranks")
    per = total // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """The rank's rows of every array of a global batch (numpy arrays or
    tensors, leading axis the batch)."""
    rows = shard_rows(len(next(iter(batch.values()))), mesh)
    return {k: v[rows] for k, v in batch.items()}


_ACTIVE: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "detectron_tpu_torch_data_parallel", default=None)


@contextlib.contextmanager
def data_parallel(mesh: Mesh):
    """Within the block, :func:`global_sum` sums over ``mesh``'s group and
    :func:`rank_rows` takes ``mesh``'s rows."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the active :func:`data_parallel`
    group, as a new tensor without gradient (a loss normalizer is a
    count); ``x`` itself without a group."""
    mesh = _ACTIVE.get()
    if mesh is None or mesh.group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def rank_rows(local: int) -> tuple[int, slice]:
    """For a rank that holds ``local`` rows: the global batch size and the
    rank's rows of it, under the active :func:`data_parallel` group;
    ``(local, all rows)`` without one. Draws made for the global batch
    and cut to these rows are the draws one process makes for it."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return local, slice(None)
    return local * mesh.world, shard_rows(local * mesh.world, mesh)


def all_reduce_sum(tensors: list[torch.Tensor], mesh: Mesh) -> None:
    """Sums ``tensors`` (one dtype and device) across the ranks, in place,
    in one all-reduce of their concatenation."""
    if mesh.group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def broadcast_state(module: torch.nn.Module, mesh: Mesh, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` set to rank ``src``'s."""
    if mesh.group is None:
        return
    for t in module.state_dict().values():
        dist.broadcast(t, src=src, group=mesh.group)


def make_train_step(detector, mesh: Mesh):
    """The data-parallel step ``(state, batch, draws=None, mark=None) ->
    metrics`` for ``detector``'s :class:`train.state.TrainState`: the
    rank's rows of the global batch in ``batch``; ``draws``, as for
    ``train_step``, are the global batch's (a generator, or ``TrainDraws``
    of the global batch). It equals ``train_step`` on the global batch
    (the module docstring says how); the losses it returns are the global
    batch's, on every rank. Without a group it is ``train_step``."""
    from detectron_tpu_torch.models.faster_rcnn import TrainDraws
    from detectron_tpu_torch.train.state import train_step

    def step(state, batch, draws=None, mark=None):
        if state.detector is not detector:
            raise ValueError("the state belongs to another detector")
        with data_parallel(mesh):
            if isinstance(draws, TrainDraws):
                rows = rank_rows(len(next(iter(batch.values()))))[1]
                draws = TrainDraws(*(d[rows] for d in draws))
            metrics = train_step(state, batch, draws, mark=mark,
                                 reduce_grads=lambda grads: all_reduce_sum(grads, mesh))
        if mesh.group is not None:
            names = sorted(metrics)
            summed = torch.stack([metrics[k].float() for k in names])
            dist.all_reduce(summed, group=mesh.group)
            metrics = dict(zip(names, summed.unbind()))
        return metrics

    return step


def make_predict_step(detector, mesh: Mesh):
    """``(params, batch) -> (Detections, masks | None)`` of the rank's rows
    of the global ``batch`` (:func:`shard_batch`), on the rank's device."""

    def predict(params, batch):
        return detector.predict_fn(params, shard_batch(batch, mesh))

    return predict

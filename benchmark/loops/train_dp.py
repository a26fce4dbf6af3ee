"""Data-parallel training over several cards: ``parallel/mesh.py``'s
``make_train_step`` in a closed loop, one process a card.

Rank 0 runs in the benchmark's own process on its device (``cuda:0``), so
that the memory peak and the trace that ``run.py`` reads are rank 0's. It
builds the hand-written kernels first (so that no two ranks build them at
once), then starts ranks 1 to ``ranks - 1`` as processes of this file,
from the checkout's root::

    python3 -m benchmark.loops.train_dp --workload <cell> --root <benchmark folder>
        --seed <n> --seconds <s> --trace <0|1> --device cuda|cpu --rank <r> --port <p>

each on ``cuda:<r>``, joined by ``torch.distributed`` (NCCL on the card, gloo
on the CPU) at a free port of localhost. Every collective times out after
``TIMEOUT_S`` and rank 0 waits at most ``JOIN_S`` for the others to end;
on any error, or when rank 0's process ends, the other ranks are killed:
a run ends or fails, and never hangs.

The mix gives the images a rank steps (``batch``), the ``ranks``, the
global batch's settings (``batch_size = batch * ranks`` and the learning
rate scaled with it, and the warm-up that rate needs), how many distinct
global batches sit on the cards with their sampling draws, the
``checked_steps`` the check compares, the ``period_steps`` that time a
step, and the steps of the traced slice.

Set-up, on every rank: the detector, and the global batches drawn from
the seed, of which the rank keeps its rows; rank 0 draws and calibrates
the weights and the global batches' sampling draws and broadcasts them;
the first ``checked_steps`` steps, whose global losses, first momentum
buffers and parameters after (rank 0's), and every rank's proposals
(gathered to rank 0), the check reads; then ``period_steps`` steps, whose
mean period on rank 0 fixes the window's step count, broadcast once, so
that the window adds no host sync a step.

The window: an all-reduce and a synchronise on every rank, then every
rank steps that many steps, then a synchronise and an all-reduce on every
rank. ``train_img_s`` is the global images stepped over the window on
rank 0's clock. Rank 0's numbers that ``loops/train.py``'s readers take
are a card's: the FLOPs of its own rows, the backward between its marks,
and its traced slice (``loops/train.py::traced_slice``, the K3 bound of
its rows), while the others step alongside. After it,
``replica_mismatch``: the largest absolute difference between rank 0's
parameters and any other rank's, 0 where every rank applied the same
summed gradient.

The check, on rank 0 once the other ranks have ended: ``loops/train.py``'s,
the reference stepping the global batch in blocks and sampling its RoIs
from every rank's proposals, its loss normalizers and its proposal stage
taken a rank's images at a time (``norms_in_blocks``, ``proposal_mismatch``):
at the global batch they would not fit beside the check.
"""

from __future__ import annotations

import argparse
import atexit
import math
import os
import socket
import subprocess
import sys
import time
from contextlib import contextmanager
from datetime import timedelta
from pathlib import Path

if __name__ == "__main__":  # a rank's own process: the checkout on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from benchmark.harness import common, flops, inputs  # noqa: E402
from benchmark.harness.spec import CHECKOUT  # noqa: E402
from benchmark.loops import train  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402
from benchmark.reference import ops  # noqa: E402

TIMEOUT_S = 300  # any collective
JOIN_S = 300  # rank 0's wait for the other ranks to end, after the window


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def join_group(run, rank: int, world: int, port: int):
    """Joins the process group; the rank's ``Mesh``."""
    from detectron_tpu_torch.parallel.mesh import make_mesh

    on_card = run.device.type == "cuda"
    if on_card:
        # a collective that fails or times out ends the process
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
        torch.cuda.set_device(run.device)
    dist.init_process_group("nccl" if on_card else "gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=timedelta(seconds=TIMEOUT_S))
    return make_mesh(run.device)


def start_ranks(run, port: int) -> list:
    """Ranks 1 to ``ranks - 1`` as processes of this file, their output on
    standard error; killed when this process ends."""
    try:
        out = sys.stderr.fileno()
    except (AttributeError, OSError, ValueError):  # a standard error with no file
        out = None
    procs = []
    for rank in range(1, int(run.mix["ranks"])):
        cmd = [sys.executable, "-m", "benchmark.loops.train_dp", "--workload", run.cell.name,
               "--root", str(run.cell.root), "--seed", str(run.seed),
               "--seconds", str(run.seconds), "--trace", str(int(run.trace)),
               "--device", run.device.type, "--rank", str(rank), "--port", str(port)]
        procs.append(subprocess.Popen(cmd, cwd=CHECKOUT, stdout=out))
    atexit.register(kill, procs)
    return procs


def kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def gather_rows(t: torch.Tensor, rank: int, world: int):
    """Every rank's ``t`` joined along its first axis, on rank 0's host; None
    on the other ranks."""
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts).to("cpu") if rank == 0 else None


def setup(run):
    """Rank 0's set-up: the kernels built, the other ranks started, then the
    set-up every rank makes."""
    if run.device.type == "cuda":
        from detectron_tpu_torch import _build

        _build.build()
    port = free_port()
    procs = start_ranks(run, port)
    try:
        state = setup_rank(run, 0, port)
    except BaseException:
        kill(procs)
        raise
    state["procs"] = procs
    return state


def setup_rank(run, rank: int, port: int) -> dict:
    from detectron_tpu_torch.parallel.mesh import make_train_step, shard_rows
    from detectron_tpu_torch.train.state import create_train_state

    world = int(run.mix["ranks"])
    mesh = join_group(run, rank, world, port)
    cfg, det = common.build(run)
    local = int(run.mix["batch"])
    batch = local * world
    data = inputs.coco_like_batches(run.seed, int(run.mix["distinct_batches"]), batch,
                                    run.settings, run.device)
    draws = train.make_draws(run, batch, len(data))
    if rank == 0:
        params = common.make_params(
            run, det, {k: v[:common.CALIBRATION_IMAGES] for k, v in data[0].items()})
    else:
        params = {k: v.detach().clone() for k, v in det.module.state_dict().items()}
    for name in sorted(params):
        dist.broadcast(params[name], 0)
    for d in draws:
        for t in d:
            dist.broadcast(t, 0)
    det.module.load_state_dict(params)
    start = common.to_host(params) if rank == 0 else None
    del params
    steps = int(run.mix["checked_steps"])
    rows = shard_rows(batch, mesh)
    feeds = [{k: v[rows].clone() for k, v in b.items()} for b in data]  # not views: the
    # global batches are freed
    kept = {"data": [common.to_host(b) for b in data[:steps]]} if rank == 0 else {}
    del data
    names = train.trainable_names(det)
    state = create_train_state(cfg, det)
    step = make_train_step(det, mesh)
    by_param = {p: n for n, p in det.module.named_parameters()}
    losses, proposals, slot = [], [], {}
    with common.captured_stages(slot):  # the checked steps, also the warm-up
        for i in range(steps):
            losses.append(step(state, feeds[i], draws=draws[i])["loss_total"])
            (scores, deltas), (boxes, valid) = slot["rpn"], slot["proposals"]
            got = ([gather_rows(s, rank, world) for s in scores],
                   [gather_rows(d, rank, world) for d in deltas],
                   gather_rows(boxes, rank, world),
                   gather_rows(valid.to(torch.uint8), rank, world))
            proposals.append(got if rank else (*got[:3], got[3].bool()))
            if i == 0 and rank == 0:
                kept["buf1"] = {by_param[p]: s["momentum_buffer"].to("cpu", copy=True)
                                for p, s in state.optimizer.state.items()}
    if rank == 0:
        named = dict(det.module.named_parameters())
        kept.update(params=start, losses=[float(x) for x in losses],
                    end={n: named[n].detach().to("cpu", copy=True) for n in names},
                    names=names, proposals=proposals,
                    draws=[ref.TrainDraws(*(t.to("cpu") for t in d)) for d in draws[:steps]])
        run.stats["flops_per_call"] = local * flops.image_flops(run.settings, train=True)
    state = {"det": det, "state": state, "data": feeds, "draws": draws, "batch": local,
             "ranks": world, "kept": kept, "step": steps, "train_step": step}
    # the period of a step, on rank 0's clock, fixes the window's steps
    common.sync(run.device)
    t0 = time.perf_counter()
    for _ in range(int(run.mix["period_steps"])):
        train._step(state)
    common.sync(run.device)
    period = (time.perf_counter() - t0) / int(run.mix["period_steps"])
    count = torch.tensor([max(1, math.ceil(run.seconds / period))], device=run.device)
    dist.broadcast(count, 0)
    state["window_steps"] = int(count)
    return state


def all_ranks_reach(run, value: torch.Tensor | None = None) -> torch.Tensor:
    """A synchronise on this rank, then an all-reduce (of ``value``, by its
    maximum) that ends when every rank has reached it."""
    value = torch.zeros(1, device=run.device) if value is None else value
    common.sync(run.device)
    dist.all_reduce(value, op=dist.ReduceOp.MAX)
    common.sync(run.device)
    return value


def window(run, state) -> dict:
    issue = common.Timer()
    marks = []

    def mark(stage):  # as loops/train.py's window: the backward between two events
        if stage in (train.FORWARD_END, "backward"):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)

    bad = torch.zeros(1, dtype=torch.int64, device=run.device)
    steps = state["window_steps"]
    all_ranks_reach(run)
    t0 = time.perf_counter()
    for _ in range(steps):
        with issue.time():
            loss = train._step(state, mark if run.trace else None)
        bad += (~torch.isfinite(loss)).to(torch.int64)
    bad = int(all_ranks_reach(run, bad))
    elapsed = time.perf_counter() - t0
    images = steps * state["batch"] * state["ranks"]
    run.stats.update(issue_s=issue.samples, calls=steps, elapsed_s=elapsed, attempted=images,
                     failed=bad * state["batch"] * state["ranks"],
                     backward_ms=[marks[i].elapsed_time(marks[i + 1])
                                  for i in range(0, len(marks) - 1, 2)])
    return {"train_img_s": images / elapsed}


traced_slice = train.traced_slice  # rank 0's; the others step alongside (step_alongside)


def step_alongside(run, state) -> None:
    for _ in range(int(run.mix["trace_calls"])):
        train._step(state)
    common.sync(run.device)


def replica_mismatch(run, state) -> float:
    """The largest absolute difference between rank 0's parameters and this
    rank's, its maximum over the ranks (on every rank): 0 where they are
    the same bits, infinite where one is not a number and the other is."""
    flat = torch.cat([p.detach().float().reshape(-1) for p in state["det"].module.parameters()])
    first = flat.clone()
    dist.broadcast(first, 0)
    gap = torch.where(flat.view(torch.int32) == first.view(torch.int32), 0.0,
                      (flat - first).abs().nan_to_num(nan=math.inf))
    return float(all_ranks_reach(run, gap.max().reshape(1)))


def release(run, state) -> dict:
    kept = state["kept"]
    kept["replica_mismatch"] = replica_mismatch(run, state)
    procs = state.pop("procs", [])
    state.clear()
    dist.destroy_process_group()
    for p in procs:
        if p.wait(timeout=JOIN_S) != 0:
            kill(procs)
            raise RuntimeError(f"a rank's process exited {p.returncode}: {p.args}")
    return kept


def loss_norms_in_blocks(mcfg, batch, draws, proposals, block: int) -> dict:
    """``reference/model.py::loss_norms`` counted ``block`` images at a time
    and summed: each normalizer counts sampled anchors or RoIs over the
    batch, a whole number, so the float32 sums are exact in any order and
    the batch's; clamped at 1 once, as there."""
    anchors_all = torch.cat(ref.anchors(mcfg, batch["image"].shape[1:3], batch["image"].device))
    cap = max(int(mcfg["roi_batch_per_image"] * mcfg["roi_positive_fraction"]), 1)
    sums = {"rpn": 0.0, "roi": 0.0, "mask": 0.0}
    for s in range(0, batch["image"].shape[0], block):
        rows = slice(s, s + block)
        part = {k: v[rows] for k, v in batch.items()}
        d = ref.TrainDraws(*(x[rows] for x in draws))
        _, cls_w, _, _ = ops.anchor_targets(
            anchors_all, part["gt_boxes"], part["gt_classes"], d.rpn_pos, d.rpn_neg,
            mcfg["rpn_positive_iou"], mcfg["rpn_negative_iou"], mcfg["rpn_batch_per_image"],
            mcfg["rpn_positive_fraction"])
        _, _, weights, _, fg_w, _ = ref.sample(mcfg, part, d, (proposals[0][rows],
                                                               proposals[1][rows]))
        sums = {"rpn": sums["rpn"] + cls_w.sum(), "roi": sums["roi"] + weights.sum(),
                "mask": sums["mask"] + fg_w[:, :cap].sum()}
    return {k: v.clamp_min(1.0) for k, v in sums.items()}


@contextmanager
def norms_in_blocks(block: int):
    """While the block runs, the reference's steps count their loss
    normalizers ``block`` images at a time (:func:`loss_norms_in_blocks`):
    ``loss_norms`` holds the IoU of every anchor with every gt box of the
    batch at once, 8.2 GiB a tensor at 64 images, and several such
    tensors do not fit beside the check."""
    plain = ref.loss_norms
    ref.loss_norms = lambda mcfg, batch, draws, proposals: loss_norms_in_blocks(
        mcfg, batch, draws, proposals, block)
    try:
        yield
    finally:
        ref.loss_norms = plain


def on_device(run, kept) -> dict:
    """``kept`` with the checked steps' batches and draws on the device, as
    ``loops/train.py``'s check reads them."""
    return {**kept, "data": [{k: v.to(run.device) for k, v in b.items()} for b in kept["data"]],
            "draws": [ref.TrainDraws(*(t.to(run.device) for t in d)) for d in kept["draws"]]}


def proposal_mismatch(run, kept, block: int) -> int:
    """``loops/train.py::proposal_mismatch`` on ``block`` images at a time
    (the proposal stage is an image's own; its NMS holds an IoU of every
    pair of an image's boxes a level)."""
    wrong = 0
    for s in range(0, kept["data"][0]["image"].shape[0], block):
        rows = slice(s, s + block)
        wrong += train.proposal_mismatch(run, {
            "proposals": [([x[rows] for x in sc], [x[rows] for x in de], b[rows], v[rows])
                          for sc, de, b, v in kept["proposals"]],
            "data": [{k: v[rows] for k, v in d.items()} for d in kept["data"]]})
    return wrong


def check(run, kept) -> dict:
    kept = on_device(run, kept)
    block = int(run.mix["batch"])
    with norms_in_blocks(block):
        out = train.numbers(kept, train.program_side(run, kept), train.reference_side(run, kept))
    out["proposal_mismatch"] = proposal_mismatch(run, kept, block)
    out["replica_mismatch"] = kept["replica_mismatch"]
    return out


def calibrate(run, kept) -> dict:
    """The program's numbers, the control's (the reference one precision
    below, the mix's ``control``, in the program's place) and a fault's
    (the reference's step on the first half of the global batch, the rows
    of half the ranks: the other half's gradients left out), all against
    the reference."""
    kept = on_device(run, kept)
    block = int(run.mix["batch"])
    half = slice(0, kept["data"][0]["image"].shape[0] // 2)
    with norms_in_blocks(block):
        reference = train.reference_side(run, kept)
        control = train.reference_side(run, kept, run.mix["control"])
        fault = train.reference_side(run, kept, rows=half)
    program_numbers = train.numbers(kept, train.program_side(run, kept), reference)
    program_numbers["proposal_mismatch"] = proposal_mismatch(run, kept, block)
    program_numbers["replica_mismatch"] = kept["replica_mismatch"]
    return {"program": program_numbers, "control": train.numbers(kept, control, reference),
            "half_batch": train.numbers(kept, fault, reference)}


def rank_main(argv=None) -> int:
    """Ranks 1 and up: set-up, the window, the traced slice's steps, the
    replica check."""
    from benchmark.harness.spec import Cell, benchmark_spec

    ap = argparse.ArgumentParser(description="one rank of a data-parallel cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    args = ap.parse_args(argv)
    cell = Cell(benchmark_spec(), args.workload, root=Path(args.root))
    device = torch.device("cuda", args.rank) if args.device == "cuda" else torch.device("cpu")
    run = common.Run(cell, args.seed, args.seconds, bool(args.trace), device)
    state = setup_rank(run, args.rank, args.port)
    window(run, state)
    if run.trace:
        step_alongside(run, state)
    replica_mismatch(run, state)
    state.clear()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())

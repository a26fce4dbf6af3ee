"""Times kernel K2 of the PyTorch port against builds of it with parts
switched off or its launch changed, at chip_smoke.py's phase-4 cases, on
one NVIDIA GPU. Run from the root of the checkout:

    python3 scripts/k2_ablation.py [--dtype bfloat16|float32] [--only NAME ...]

Each variant is ``detectron_tpu_torch/csrc/roi_align.cu`` with a few lines
replaced (``VARIANTS``: the float32 kernel's, ``BF16_VARIANTS``: the bf16
kernel's, by ``--dtype``, bf16 by default), compiled with the port's nvcc
flags into ``build/k2_ablation/``, all at once. A variant with a part
switched off computes a wrong result: it is only timed. The unchanged
kernel is held against the plain version first. Every variant is timed at
each case in two rounds, the second in the reverse order, by chip_smoke's
``cuda_ms`` (CUDA events, the device alone) on chip_smoke's phase-4 inputs
(its seeded features and RoIs, routing span (28, 44)). Prints one line per
variant and case, then a JSON line of every reading and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from detectron_tpu_torch import _build  # noqa: E402
from detectron_tpu_torch.ops import roi_align as ra  # noqa: E402

OUT_DIR = REPO / "build" / "k2_ablation"

# --- the float32 kernel (roi_align_forward_kernel), its lines as it has them
PASS_X = """
        ring[(((r0 + r) & mask) * pool + q) * kV4 + c4] =
            taps.contract(buf + r * nx * kV4, kV4, -1);"""
PASS_Y = "\n        float4 acc = taps.contract(ring + q * kV4 + c4, pool * kV4, mask);"
COPY = "      cp_async16(buf + e * kCopies,"
SET_UP_END = "\n  const int nx = ft.cells[0], ny = ft.cells[1];"
NO_PASS_X = (PASS_X, "")
NO_PASS_Y = (PASS_Y, "\n        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);")
NO_COPIES = (COPY, "      if (false) " + COPY.lstrip())


def blocks_per_sm(k):
    return ("constexpr int kFwdBlocksPerSm = 8;", f"constexpr int kFwdBlocksPerSm = {k};")


# name -> (what it changes, [(text of the kernel, its replacement), ...])
VARIANTS = {
    "kernel": ("the kernel as committed", []),
    "generic S": ("the instance with S at run time (taps from shared memory), not S=2's",
                  [("return ratio == 2 ? launch_fwd<T, kSlice, 2,",
                    "return ratio < 0 ? launch_fwd<T, kSlice, 2,")]),
    "1 block a RoI": ("all of a RoI's slices in one block (the set-up once a RoI)",
                      [blocks_per_sm(1)]),
    "split to 4 an SM": ("slices split until 4 blocks an SM, not 8", [blocks_per_sm(4)]),
    "block a slice": ("one block per (RoI, slice): the set-up in every block",
                      [blocks_per_sm(1 << 20)]),
    "no pass x": ("pass x switched off", [NO_PASS_X]),
    "no pass y": ("pass y switched off (zeros stored)", [NO_PASS_Y]),
    "no passes": ("both passes switched off", [NO_PASS_X, NO_PASS_Y]),
    "no copies": ("the cp.async copies switched off", [NO_COPIES]),
    "set-up, loop, stores": ("copies and passes switched off",
                             [NO_COPIES, NO_PASS_X, NO_PASS_Y]),
    "set-up only": ("the block ends after the set-up (one value stored a block)",
                    [(SET_UP_END, SET_UP_END + "\n  if (t == 0) out[blockIdx.x] = nx + ny;"
                      "\n  if (nx >= 0) return;")]),
}

# --- the bf16 kernel (roi_align_forward_bf16_kernel): its consumers' passes
# are the float32 kernel's, four spaces deeper
BF16_PASS_X = """
            ring[(((r0 + r) & mask) * pool + q) * kV4 + c4] =
                taps.contract_all(buf + r * nx * kV4, kV4, -1);"""
BF16_PASS_Y = "\n            const float4 a = taps.contract_all(ring + q * kV4 + c4, pool * kV4, mask);"
BF16_NO_PASSES = [(BF16_PASS_X, ""),
                  (BF16_PASS_Y, "\n            const float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);")]
BF16_COPY = "              cp_async16(buf + e, feat"
BF16_NO_COPIES = [(BF16_COPY, "              if (false) " + BF16_COPY.lstrip())]
# the copy warps' loop (each 16-byte copy after its own cell's coordinates),
# and two alternatives: a batch of four cells' coordinates loaded before
# their copies, and one bulk asynchronous copy (cp.async.bulk, the Tensor
# Memory Accelerator) a cell, its bytes expected on the stage's barrier by
# the first copy thread
COPY_LOOP = """            uint4* buf = stage + s * stage_cells * kCopies;
            const int copies = min(chunk, ny - r0) * nx * kCopies;
#pragma unroll 4
            for (int e = ct; e < copies; e += 32 * kBf16CopyWarps) {
              const int cell = e / kCopies;
              const int r = div_small(cell, by_nx);
              const int x = cell - r * nx;
              cp_async16(buf + e, feat + (static_cast<size_t>(ft.cell[1][r0 + r]) * width +
                                          ft.cell[0][x]) * channels +
                                      j * kSlice + (e - cell * kCopies) * 8);
            }
            cp_async_arrive(&sh.full[s]);
"""
BATCH_LOOP = """            const int part = ct % kCopies;
            constexpr int kCellStep = 32 * kBf16CopyWarps / kCopies;
            uint4* buf = stage + s * stage_cells * kCopies + part;
            const __nv_bfloat16* src = feat + j * kSlice + part * 8;
            const int cells = min(chunk, ny - r0) * nx;
            for (int c0 = ct / kCopies; c0 < cells; c0 += 4 * kCellStep) {
              int y[4], x[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int cell = min(c0 + i * kCellStep, cells - 1);
                const int r = div_small(cell, by_nx);
                y[i] = ft.cell[1][r0 + r];
                x[i] = ft.cell[0][cell - r * nx];
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int cell = c0 + i * kCellStep;
                if (cell < cells) {
                  cp_async16(buf + cell * kCopies,
                             src + (static_cast<size_t>(y[i]) * width + x[i]) * channels);
                }
              }
            }
            cp_async_arrive(&sh.full[s]);
"""
BULK_LOOP = """            uint4* buf = stage + s * stage_cells * kCopies;
            const int cells = min(chunk, ny - r0) * nx;
            if (ct == 0) {
              asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"
                           ::"r"(smem_u32(&sh.full[s])), "r"(cells * kSlice * 2) : "memory");
            }
            asm volatile("bar.sync 2, %0;\\n" ::"n"(32 * kBf16CopyWarps) : "memory");
            asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
            for (int cell = ct; cell < cells; cell += 32 * kBf16CopyWarps) {
              const int r = div_small(cell, by_nx);
              const int x = cell - r * nx;
              asm volatile(
                  "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
                  "%2, [%3];\\n" ::"r"(smem_u32(buf + cell * kCopies)),
                  "l"(feat + (static_cast<size_t>(ft.cell[1][r0 + r]) * width + ft.cell[0][x]) *
                                 channels + j * kSlice),
                  "r"(kSlice * 2), "r"(smem_u32(&sh.full[s])) : "memory");
            }
"""
BF16_COPIES_BATCHED = [(COPY_LOOP, BATCH_LOOP)]
BF16_BULK = [(COPY_LOOP, BULK_LOOP),
             ("      mbar_init(&sh.full[s], 32 * kBf16CopyWarps);", "      mbar_init(&sh.full[s], 1);")]
# the walk: units strided over the blocks, and the alternative: each block a
# contiguous range of units
UNIT_LOOP = "for (int unit = blockIdx.x, k = 0; unit < units; unit += gridDim.x, ++k) {"
BF16_CONTIGUOUS = [
    ("  const int units = num_rois * groups;\n",
     "  const int units = num_rois * groups;\n"
     "  const int begin = static_cast<long long>(units) * blockIdx.x / gridDim.x;\n"
     "  const int end = static_cast<long long>(units) * (blockIdx.x + 1) / gridDim.x;\n"),
    (UNIT_LOOP, "for (int unit = begin, k = 0; unit < end; ++unit, ++k) {", 3)]


UNIT_RULE = """  int per = slices;
  while (per % 2 == 0 &&
         static_cast<long long>(num_rois) * (slices / per) < kBf16UnitsPerBlock * blocks) {
    per /= 2;
  }
  return per;
"""


def bf16_constants(**values):
    """Edits of the bf16 kernel's constants (name without kBf16: value)."""
    now = {"Consumers": "256", "Stages": "4", "StageBytes": "16 * 1024",
           "RingBytes": "32 * 1024", "BlocksPerSm": "2", "SmemLimit": "95 * 1024",
           "CopyWarps": "4"}
    return [(f"constexpr int kBf16{k} = {now[k]};", f"constexpr int kBf16{k} = {v};")
            for k, v in values.items()]


BF16_VARIANTS = {
    "kernel": ("the kernel as committed", []),
    "generic S": ("the instance with S at run time (taps from shared memory), not S=2's",
                  [("return ratio == 2 ? launch_fwd_bf16<kSlice, 2,",
                    "return ratio < 0 ? launch_fwd_bf16<kSlice, 2,")]),
    "bulk copies": ("one bulk copy a cell (cp.async.bulk), not 16-byte cp.async", BF16_BULK),
    "contiguous walk": ("each block a contiguous range of units, not units strided over the "
                        "blocks", BF16_CONTIGUOUS),
    "loads in turn": ("each tap's load after the sum before it (the fp32 kernel's contract), "
                      "not all loads first", [("taps.contract_all(", "taps.contract(", 2)]),
    "copies batched": ("four cells' coordinates loaded before their copies, not each copy "
                       "after its own", BF16_COPIES_BATCHED),
    "2 copy warps": ("two copy warps, not four", bf16_constants(CopyWarps=2)),
    "3 copy warps": ("three copy warps, not four", bf16_constants(CopyWarps=3)),
    "whole RoIs": ("units of all of a RoI's slices, not split to four units a block",
                   [(UNIT_RULE, "  return slices;\n")]),
    "units of 1 slice": ("units of one slice always, not split to four units a block",
                         [(UNIT_RULE, "  return 1;\n")]),
    "hashed walk": ("the units of a block's walk spread by a multiplicative hash (i x 1000003 "
                    "mod units), not strided in index order",
                    [(UNIT_LOOP, "for (int i = blockIdx.x, k = 0; i < units; i += gridDim.x, ++k) {"
                      " const int unit = static_cast<int>(static_cast<long long>(i) * 1000003 % "
                      "units);", 3)]),
    "no wait hint": ("mbarrier waits with the card's default suspend time, not 1 ms",
                     [("mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;",
                       "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;")]),
    "no copies": ("the producer's copies switched off", BF16_NO_COPIES),
    "no passes": ("the consumers' passes switched off (zeros stored)", BF16_NO_PASSES),
    "set-up only": ("copies and passes switched off: the set-up role alone, with the "
                    "consumers' barriers and stores", BF16_NO_COPIES + BF16_NO_PASSES),
    "1 stage": ("one stage: each chunk's copies and passes in series, no overlap of the two",
                bf16_constants(Stages=1)),
    "2 stages": ("two stages, not four", bf16_constants(Stages=2)),
    "1 block, 24 consumer warps": ("one block an SM of 24 consumer warps, 32 KB stages and a "
                                   "64 KB ring, not two of 8, 16 and 32", bf16_constants(
                                       Consumers=768, BlocksPerSm=1, SmemLimit="200 * 1024",
                                       StageBytes="32 * 1024", RingBytes="64 * 1024")),
}


def variant_source(edits, name="roi_align") -> str:
    """``csrc/<name>.cu`` with each edit ``(old, new[, count])`` made: ``old``
    must occur ``count`` times (once by default)."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for old, new, *count in edits:
        if src.count(old) != (count[0] if count else 1):
            raise SystemExit(f"ablation: {old!r} is not {count[0] if count else 1} times in "
                             f"{name}.cu")
        src = src.replace(old, new)
    return src


def build_variants(variants, name="roi_align", out_dir=OUT_DIR) -> dict:
    """Compiles every variant of ``csrc/<name>.cu``, all at once; returns
    variant name -> loaded library."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (variant, (_, edits)) in enumerate(variants.items()):
        src = out_dir / f"v{i}.cu"
        src.write_text(variant_source(edits, name))
        lib = out_dir / f"v{i}.so"
        procs[variant] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"ablation: {variant}: nvcc exited {proc.returncode}\n{log}")
        libs[variant] = ctypes.CDLL(str(lib))
    return libs


def forward_fn(lib, dtype):
    fn = lib.roi_align_forward if dtype == torch.float32 else lib.roi_align_forward_bf16
    fn.argtypes = [  # as ops/roi_align.py binds it
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def forward(fn, feats, rois, levels, p, out):
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    err = fn(*ra._level_args(feats, cs.STRIDES), rois.data_ptr(), levels.data_ptr(),
             out.data_ptr(), b * r, r, c, p, 2, 0, _build.stream_handle(rois.device))
    _build.check(err, "roi_align_forward")


def smoke_draws():
    """chip_smoke.py's generator as phase 4 finds it: seed 0, after phase 3's
    draws of its main and edge cases (numpy only), so that the features and
    RoIs here are chip_smoke's phase-4 inputs."""
    rng = np.random.RandomState(0)
    for case in cs.NMS_CASES:
        cs.nms_problems(rng, case["g"], case["n"], (1024, 1344), case["n_invalid"],
                        case["classes"])
    for case in cs.NMS_EDGE_CASES:
        cs.nms_problems(rng, case["g"], case["n"], (1024, 1344), case["n_invalid"])
    return rng


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--only", nargs="*", help="time these variants (and the kernel) only")
    args = parser.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    variants = BF16_VARIANTS if dtype == torch.bfloat16 else VARIANTS
    if args.only:
        variants = {k: v for k, v in variants.items() if k == "kernel" or k in args.only}
    card = cs.phase_device()
    fns = {k: forward_fn(lib, dtype) for k, lib in build_variants(variants).items()}
    rng = smoke_draws()
    feats = [f.to(dtype) for f in cs.level_features(rng)]
    fmax = max(float(f.float().abs().max()) for f in feats)
    order = list(variants)
    readings = []
    for path, p, r in cs.ROI_CASES:
        rois = torch.tensor(cs.roi_cases(rng, 2, r, cs.CANVAS), device=cs.DEVICE)
        levels = ra.assign_fpn_levels(rois, len(feats), 2, max_span=(28.0, 44.0))
        out = torch.empty((2, r, p, p, feats[0].shape[-1]), dtype=dtype, device=cs.DEVICE)
        forward(fns["kernel"], feats, rois, levels, p, out)
        want = ra.multilevel_roi_align_plain(feats, rois, levels, cs.STRIDES, p, 2)
        if dtype == torch.bfloat16:
            diff, ok = cs.within_bf16(out, want, 1e-5 * fmax)
        else:
            diff = float((out - want).abs().max())
            ok = diff <= 1e-5 * fmax
        if not ok:
            raise SystemExit(f"ablation: the kernel is off by {diff} at P={p} R={r}")
        b_ms, _, _ = cs.k2_bound(feats, rois, levels, p)
        times = {name: [] for name in order}
        for names in (order, order[::-1]):
            for name in names:
                times[name].append(cs.cuda_ms(
                    lambda: forward(fns[name], feats, rois, levels, p, out)))
        for name in order:
            ms = times[name]
            cs.log(f"[{args.dtype} {path} P={p} R={r}] {name:20s} {ms[0]:.4f} {ms[1]:.4f} ms "
                   f"({np.mean(ms) / np.mean(times['kernel']):.2f}x the kernel; "
                   f"bound {b_ms:.4f}) - {variants[name][0]}")
        readings.append(dict(case=f"{path} P{p} R{r}", dtype=args.dtype, bound_ms=b_ms,
                             max_abs_err=diff, ms=times))
    print(json.dumps({"k2_ablation": readings}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(REPO)
    sys.exit(main())

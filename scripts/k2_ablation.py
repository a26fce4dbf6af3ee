"""Times kernel K2 of the PyTorch port against builds of it with parts
switched off or its launch changed, at chip_smoke.py's phase-4 cases, on
one NVIDIA GPU. Run from the root of the checkout:

    python3 scripts/k2_ablation.py

Each variant is ``detectron_tpu_torch/csrc/roi_align.cu`` with a few lines
replaced (``VARIANTS``), compiled with the port's nvcc flags into
``build/k2_ablation/``, all at once. A variant with a part switched off
computes a wrong result: it is only timed. The unchanged kernel is held
against the plain version first. Every variant is timed at each case in
two rounds, the second in the reverse order, by chip_smoke's ``cuda_ms``
(CUDA events, the device alone) on chip_smoke's seeded inputs (seed 0,
routing span (28, 44)). Prints one line per variant and case, then a JSON
line of every reading and the card's name and power limit.
"""

from __future__ import annotations

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

# the passes' lines, as the kernel has them
PASS_X = """        ring[(((r0 + r) & mask) * pool + q) * kV4 + c4] =
            taps.contract(buf + r * nx * kV4, kV4, -1);"""
PASS_Y = "        float4 acc = taps.contract(ring + q * kV4 + c4, pool * kV4, mask);"
COPY = "      cp_async16(buf + e * kV4,"
SET_UP_END = "  const int nx = ft.cells[0], ny = ft.cells[1];"
NO_PASS_X = (PASS_X, "")
NO_PASS_Y = (PASS_Y, "        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);")
NO_COPIES = (COPY, "      if (false) " + COPY.lstrip())


def blocks_per_sm(k):
    return ("constexpr int kFwdBlocksPerSm = 8;", f"constexpr int kFwdBlocksPerSm = {k};")


# name -> (what it changes, [(text of the kernel, its replacement), ...])
VARIANTS = {
    "kernel": ("the kernel as committed", []),
    "generic S": ("the instance with S at run time (taps from shared memory), not S=2's",
                  [("return ratio == 2 ? launch_fwd<kSlice, 2>",
                    "return ratio < 0 ? launch_fwd<kSlice, 2>")]),
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


def variant_source(edits) -> str:
    src = (_build.CSRC / "roi_align.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"k2_ablation: {old!r} is not once in roi_align.cu")
        src = src.replace(old, new)
    return src


def build_variants() -> dict:
    """Compiles every variant, all at once; returns name -> library."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (_, edits)) in enumerate(VARIANTS.items()):
        src = OUT_DIR / f"v{i}.cu"
        src.write_text(variant_source(edits))
        lib = OUT_DIR / f"v{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k2_ablation: {name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        fn = libs[name].roi_align_forward
        fn.argtypes = [  # as ops/roi_align.py binds it
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return libs


def forward(lib, feats, rois, levels, p, out):
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    err = lib.roi_align_forward(
        *ra._level_args(feats, cs.STRIDES), rois.data_ptr(), levels.data_ptr(),
        out.data_ptr(), b * r, r, c, p, 2, _build.stream_handle(rois.device))
    _build.check(err, "roi_align_forward")


def main() -> int:
    card = cs.phase_device()
    libs = build_variants()
    rng = np.random.RandomState(0)
    feats = cs.level_features(rng)
    fmax = max(float(f.abs().max()) for f in feats)
    order = list(VARIANTS)
    readings = []
    for path, p, r in cs.ROI_CASES:
        rois = torch.tensor(cs.roi_cases(rng, 2, r, cs.CANVAS), device=cs.DEVICE)
        levels = ra.assign_fpn_levels(rois, len(feats), 2, max_span=(28.0, 44.0))
        out = torch.empty((2, r, p, p, feats[0].shape[-1]), device=cs.DEVICE)
        forward(libs["kernel"], feats, rois, levels, p, out)
        want = ra.multilevel_roi_align_plain(feats, rois, levels, cs.STRIDES, p, 2)
        diff = float((out - want).abs().max())
        if not diff <= 1e-5 * fmax:
            raise SystemExit(f"k2_ablation: the kernel is off by {diff} at P={p} R={r}")
        b_ms, _, _ = cs.k2_bound(feats, rois, levels, p)
        times = {name: [] for name in order}
        for names in (order, order[::-1]):
            for name in names:
                times[name].append(cs.cuda_ms(
                    lambda: forward(libs[name], feats, rois, levels, p, out)))
        for name in order:
            ms = times[name]
            cs.log(f"[{path} P={p} R={r}] {name:22s} {ms[0]:.4f} {ms[1]:.4f} ms "
                   f"({np.mean(ms) / np.mean(times['kernel']):.2f}x the kernel; "
                   f"bound {b_ms:.4f}) - {VARIANTS[name][0]}")
        readings.append(dict(case=f"{path} P{p} R{r}", bound_ms=b_ms, max_abs_err=diff,
                             ms=times))
    print(json.dumps({"k2_ablation": readings}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(REPO)
    sys.exit(main())

"""Times the wide scan of kernel K1 (NMS past 8192 boxes) against a build
that reads the kept rows' live words straight from L2, at chip_smoke.py's
NMS_WIDE_CASES, on one NVIDIA GPU. Run from the root of the checkout:

    python3 scripts/k1_wide_ablation.py

The variant is ``detectron_tpu_torch/csrc/nms.cu`` with the wide scan's
fold replaced (``VARIANTS``), built as scripts/k2_ablation.py builds its
variants, into ``build/k1_wide_ablation/``. Each variant's keep masks are
held exactly against the plain version, with and without the case's
max_keep = min(max_out, N); then the scan alone (one mask, computed once)
is timed for each, in two rounds, the second in the reverse order, by
chip_smoke's ``cuda_ms``. Prints one line per variant and case, then a
JSON line of every reading and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from detectron_tpu_torch import _build  # noqa: E402
from detectron_tpu_torch.ops import nms  # noqa: E402
from k2_ablation import build_variants  # noqa: E402

OUT_DIR = REPO / "build" / "k1_wide_ablation"

# the wide scan's fold of a chunk's kept rows into the removed words, from
# its window size to the end of its window loop
FOLD_START = "      const int slot = (kWideStageWords / count) & ~1;\n"
FOLD_END = "        __syncwarp();  // every lane is done with the stage before it is refilled\n      }\n"
# the alternative: each lane ORs its words of every kept row, read from
# device memory (L2), eight rows' loads in flight
FROM_L2 = """      for (int w = rb + 1 + lane; w < words; w += 32) {
        u64 acc = 0ull;
#pragma unroll 8
        for (int k = 0; k < count; ++k) acc |= gmask[(size_t)(i0 + order[k]) * words + w];
        removed[w] |= acc;
      }
"""


def fold_block() -> str:
    src = (_build.CSRC / "nms.cu").read_text()
    i = src.index(FOLD_START)
    return src[i:src.index(FOLD_END, i) + len(FOLD_END)]


VARIANTS = {
    "kernel": ("the kernel as committed: bulk copies of the live words into a 64 KB stage",
               []),
    "from L2": ("the live words read straight from device memory (L2), lane-strided",
                [(fold_block(), FROM_L2)]),
}


def bind(lib):
    lib.nms_mask.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.nms_scan.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.nms_mask.restype = lib.nms_scan.restype = ctypes.c_int
    return lib


def scan(lib, mask, svalid, max_keep):
    g, n = svalid.shape
    keep = torch.empty((g, n), dtype=torch.bool, device=svalid.device)
    err = lib.nms_scan(mask.data_ptr(), svalid.data_ptr(), keep.data_ptr(), g, n, max_keep,
                       _build.stream_handle(svalid.device))
    _build.check(err, "nms_scan")
    return keep


def main() -> int:
    card = cs.phase_device()
    libs = {k: bind(v) for k, v in build_variants(VARIANTS, "nms", OUT_DIR).items()}
    rng = np.random.RandomState(0)
    order = list(VARIANTS)
    readings = []
    for case in cs.NMS_WIDE_CASES:
        boxes, scores, valid, cls = cs.nms_problems(rng, case["g"], case["n"], (1024, 1344),
                                                    case["n_invalid"], case["classes"])
        tb, ts, tv = (torch.tensor(x, device=cs.DEVICE) for x in (boxes, scores, valid))
        if cls is not None:
            span = tb.amax(dim=(1, 2)) - tb.amin(dim=(1, 2)) + 1.0
            tb = tb + (torch.tensor(cls, device=cs.DEVICE).to(tb.dtype) * span[:, None])[..., None]
        sboxes, svalid = cs.sorted_problems(tb, ts, tv)
        n, thresh = case["n"], case["thresh"]
        m = min(case["max_out"], n)
        mask = nms.nms_mask_cuda(sboxes, thresh)
        times = {}
        for max_keep in (n, m):
            want = nms.greedy_keep_plain(sboxes, svalid, thresh, max_keep=max_keep)
            for name in order:
                got = scan(libs[name], mask, svalid, max_keep)
                if not torch.equal(got, want):
                    raise SystemExit(f"k1_wide_ablation: {name} differs at {case['name']} "
                                     f"max_keep={max_keep}")
            for names in (order, order[::-1]):
                for name in names:
                    times.setdefault(f"{name} max_keep={max_keep}", []).append(cs.cuda_ms(
                        lambda: scan(libs[name], mask, svalid, max_keep), iters=10))
        for key, ms in times.items():
            cs.log(f"[K1 wide {case['name']}] {key:28s} scan {ms[0]:.4f} {ms[1]:.4f} ms")
        readings.append(dict(case=case["name"], g=case["g"], n=n, max_keep=m, scan_ms=times))
    print(json.dumps({"k1_wide_ablation": readings}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(REPO)
    sys.exit(main())

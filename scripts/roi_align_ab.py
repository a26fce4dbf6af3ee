"""Kernels K2 and K3 at aligned=False from two trees of this repository, on
the card in one run: their times, their registers and occupancy, and
whether their machine code is the same.

    python3 scripts/roi_align_ab.py --parent DIR [--change DIR] [--rounds 2]

``--change`` defaults to this script's own tree. For each tree:

1. its kernels are built by its own ``detectron_tpu_torch/_build.py``
   (into its ``build/kernels/``), and its ``csrc/roi_align.cu`` into a
   probe that includes the source and reports, through ``cudaFuncGetAttributes`` and
   ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, the registers a
   thread, static shared memory, local memory and blocks an SM of each
   instance that the training step runs at C=256 (K2 float32 and bf16 at
   P=7 and 14; K3 float32; K3 bf16's pre-pass and tile kernel), at the
   dynamic shared memory its launch asks for (all builds at once, one
   ``nvcc`` each);
2. ``cuobjdump -sass`` of the library: each kernel instance's instructions
   (addresses and encodings dropped), matched by name between the trees
   with the change's ``aligned`` template argument ``false`` taken out;
   the same for K1's library (``csrc/nms.cu``), the change's float32
   instance of a mask kernel templated on the box type matched with the
   parent's kernel (``nms_sass``);
3. the four kernels timed at PERF.md's training shapes (B=2, the P2-P5
   levels of a 1024x1344 canvas, C=256; R=512 at P=7 and R=128 at P=14
   an image, chip_smoke.py's RoIs routed with the span (28, 44)) by
   ``chip_smoke.cuda_ms`` (20 calls after 3 warm-ups), each tree in a
   process of its own, in turns: parent, change, change, parent, once a
   round. Every call goes through the tree's own wrappers, positional
   arguments only, so the parent's (which have no ``aligned``) run as
   they are.

Prints one line a measurement and, last, a JSON object of them all.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
CASES = ((7, 512), (14, 128))  # (P, RoIs an image)

# the probe, after the tree's source: the resources of the instances that the
# training step's shapes take at C=256, S=2 (the probe checks the launchers'
# picks first), in PROBE_LABELS' order; {A} is the aligned argument's place
PROBE_BODY = r"""
template <typename K>
static int put(K kernel, int threads, int smem, int limit, bool carveout, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         limit);
  if (err == cudaSuccess && carveout) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  }
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = blocks;
  out[4] = smem;
  return static_cast<int>(err);
}

extern "C" int probe(int* out) {
  // the slices the launchers pick at C=256, S=2
  const auto fwd = [](int p, int r, int s) { return fwd_smem_bytes(p, r, s, 4); };
  const auto tiles = [](int p, int, int s) { return tile_smem_bytes(kTile, p, s); };
  if (pick_slice({64, 32, 4}, 256, 7, 2, kFwdSmemLimit, fwd) != 64 ||
      pick_slice({64, 32, 4}, 256, 14, 2, kFwdSmemLimit, fwd) != 64 ||
      bf16_slice(256, 7, 2) != 64 || bf16_slice(256, 14, 2) != 64 ||
      pick_slice({32, 16, 8, 4}, 256, 7, 2, kBwdSmemLimit, bwd_smem_bytes) != 32 ||
      pick_slice({32, 16, 8, 4}, 256, 14, 2, kBwdSmemLimit, bwd_smem_bytes) != 16 ||
      tile_smem_bytes(kWideTile, 7, kWideSlice) > kWideSmemLimit ||
      tile_smem_bytes(kWideTile, 14, kWideSlice) <= kWideSmemLimit ||
      pick_slice({32, 16, 8}, 256, 14, 2, kTileSmemLimit, tiles) != 32) {
    return -1;
  }
  int err = 0;
  err |= put(roi_align_forward_kernel<float, 64, 2{A}>, kThreads, fwd(7, 2, 64),
             kFwdSmemLimit, false, out + 0);
  err |= put(roi_align_forward_kernel<float, 64, 2{A}>, kThreads, fwd(14, 2, 64),
             kFwdSmemLimit, false, out + 5);
  err |= put(roi_align_forward_bf16_kernel<64, 2{A}>, kBf16Threads, bf16_smem_bytes(7, 2, 64),
             kBf16SmemLimit, true, out + 10);
  err |= put(roi_align_forward_bf16_kernel<64, 2{A}>, kBf16Threads, bf16_smem_bytes(14, 2, 64),
             kBf16SmemLimit, true, out + 15);
  err |= put(roi_align_backward_kernel<32{A}>, kThreads, bwd_smem_bytes(7, 2, 32),
             kBwdSmemLimit, false, out + 20);
  err |= put(roi_align_backward_kernel<16{A}>, kThreads, bwd_smem_bytes(14, 2, 16),
             kBwdSmemLimit, false, out + 25);
  err |= put({PREPASS}, 32 * kBoundsWarps, 0, 0, false, out + 30);
  err |= put(roi_align_backward_tiles_kernel<kWideTile, kWideSlice, 512, 1{A}>, 512,
             tile_smem_bytes(kWideTile, 7, kWideSlice), kWideSmemLimit, false, out + 35);
  err |= put(roi_align_backward_tiles_kernel<kTile, 32, kThreads, 2{A}>, kThreads,
             tile_smem_bytes(kTile, 14, 32), kTileSmemLimit, false, out + 40);
  return err;
}
"""
PROBE_LABELS = ("K2 float32 P=7", "K2 float32 P=14", "K2 bf16 P=7", "K2 bf16 P=14",
                "K3 float32 P=7", "K3 float32 P=14", "K3 bf16 pre-pass",
                "K3 bf16 tiles P=7", "K3 bf16 tiles P=14")
PROBE_FIELDS = ("registers", "static_smem", "local_bytes", "blocks_per_sm", "dynamic_smem")


def log(*args):
    print(*args, flush=True)


def templated(tree: Path) -> bool:
    """Whether the tree's kernels take ``aligned`` as a template argument."""
    source = (tree / "detectron_tpu_torch/csrc/roi_align.cu").read_text()
    return "template <bool kAligned>" in source


def probe_source(tree: Path) -> str:
    aligned = templated(tree)
    body = PROBE_BODY.replace("{A}", ", false" if aligned else "")
    body = body.replace("{PREPASS}", "roi_tap_bounds_kernel<false>" if aligned
                        else "roi_tap_bounds_kernel")
    return f'#include "{tree / "detectron_tpu_torch/csrc/roi_align.cu"}"\n' + body


# run in a tree: its own build of its kernels, then the RoIAlign library's path
TREE_BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "from detectron_tpu_torch import _build; _build.build(); "
              "print(_build.library_path('roi_align')); print(_build.library_path('nms'))")


def build(trees, out: Path):
    """Each tree's own build of its kernels and its probe, all at once.
    Returns {tree: [RoIAlign library, probe, NMS library]}."""
    sys.path.insert(0, str(HERE))
    from detectron_tpu_torch import _build

    procs = []
    for i, tree in enumerate(trees):
        probe, src = out / f"probe{i}.so", out / f"probe{i}.cu"
        src.write_text(probe_source(tree))
        procs.append((tree, "probe", probe, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(probe), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        procs.append((tree, "library", None, subprocess.Popen(
            [sys.executable, "-c", TREE_BUILD, str(tree)], cwd=tree, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    paths = {tree: [None, None, None] for tree in trees}
    for tree, what, target, proc in procs:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"roi_align_ab: the {what} of {tree} failed to build\n{report}")
        if what == "probe":
            paths[tree][1] = target
        else:
            paths[tree][0], paths[tree][2] = (Path(x) for x in
                                              report.strip().splitlines()[-2:])
    return paths


def read_probe(probe: Path) -> dict:
    import ctypes

    import torch

    torch.cuda.init()
    out = (ctypes.c_int * (5 * len(PROBE_LABELS)))()
    lib = ctypes.CDLL(str(probe))
    lib.probe.argtypes = [ctypes.POINTER(ctypes.c_int)]
    err = lib.probe(out)
    if err:
        raise SystemExit(f"roi_align_ab: probe {probe} returned {err}")
    return {label: dict(zip(PROBE_FIELDS, out[5 * i:5 * i + 5]))
            for i, label in enumerate(PROBE_LABELS)}


def sass(lib: Path, aligned_arg: bool) -> dict:
    """{kernel instance: instructions} of a library, the name demangled and,
    for a tree with ``aligned`` template arguments, the aligned=False
    instances only, their ``, false`` taken out of the name."""
    cuda = Path(_nvcc_home())
    text = subprocess.run([str(cuda / "bin/cuobjdump"), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    mangled = parts[1::2]
    names = subprocess.run([str(cuda / "bin/cu++filt")], input="\n".join(mangled),
                           check=True, capture_output=True, text=True).stdout.splitlines()
    out = {}
    for symbol, name, body in zip(mangled, names, parts[2::2]):
        code = [re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()
                for line in body.splitlines() if re.search(r"/\*[0-9a-f]{4,}\*/", line)]
        # calls into the function's own subroutines (the IEEE division's slow
        # path) name them after the function's symbol, which a template
        # argument changes
        code = [re.sub(r"\s*/\* 0x[0-9a-f]+ \*/", "", c).replace(symbol, "<self>")
                for c in code]
        if aligned_arg:
            if "true>" in name or "(bool)1>" in name:
                continue
            name = re.sub(r", (false|\(bool\)0)>", ">", name)
            name = re.sub(r"<(false|\(bool\)0)>", "", name)
        # a function template's name carries its return type
        out[re.sub(r"^void ", "", name)] = code
    return out


def nms_sass(lib: Path) -> dict:
    """{kernel instance: instructions} of an NMS library, the float32 mask
    kernel under one name in both trees: the change's mask kernel is a
    template on the box type, whose float4 instance is the parent's kernel
    and whose uint2 (bf16) instance has no counterpart there."""
    out = {}
    for name, code in sass(lib, False).items():
        if "<uint2>" in name:
            continue
        out[name.replace("nms_mask_kernel<float4>(const T1 *",
                         "nms_mask_kernel(const float4 *")] = code
    return out


def _nvcc_home() -> str:
    sys.path.insert(0, str(HERE))
    from detectron_tpu_torch import _build

    return str(Path(_build.nvcc()).parent.parent)


def worker(tree: Path) -> dict:
    """Times the four kernels through ``tree``'s wrappers (run in a process
    whose ``detectron_tpu_torch`` and ``chip_smoke`` are the tree's)."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke as cs
    from detectron_tpu_torch.ops import roi_align as ra

    assert Path(ra.__file__).resolve().is_relative_to(tree.resolve()), ra.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    feats = cs.level_features(rng)
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    times = {}
    for p, r in CASES:
        rois = torch.tensor(cs.roi_cases(rng, 2, r, cs.CANVAS), device="cuda")
        levels = ra.assign_fpn_levels(rois, 4, 2, max_span=(28.0, 44.0))
        g = torch.tensor(rng.randn(2, r, p, p, feats[0].shape[-1]).astype(np.float32),
                         device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            fs = [f.to(dtype) for f in feats]
            gd = g.to(dtype)
            name = str(dtype).replace("torch.", "")
            times[f"K2 {name} P={p} R={r}"] = cs.cuda_ms(
                lambda: ra.multilevel_roi_align_cuda(fs, rois, levels, cs.STRIDES, p, 2))
            times[f"K3 {name} P={p} R={r}"] = cs.cuda_ms(
                lambda: ra.multilevel_roi_align_bwd_cuda(gd, level_hw, rois, levels,
                                                         cs.STRIDES, 2))
    return times


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, required=True)
    parser.add_argument("--change", type=Path, default=HERE)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("roi_align_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[card] {card}")
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    result = {"card": card}
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        paths = build(list(trees.values()), Path(tmp))
        probes = {k: read_probe(paths[t][1]) for k, t in trees.items()}
        for label in PROBE_LABELS:
            log(f"[resources] {label}: " + "; ".join(
                f"{k} " + ", ".join(f"{f} {probes[k][label][f]}" for f in PROBE_FIELDS)
                for k in trees))
        result["resources"] = probes
        code = {k: sass(paths[t][0], templated(t)) for k, t in trees.items()}
        same = {name: code["change"].get(name) == body for name, body in code["parent"].items()}
        for name, equal in sorted(same.items()):
            log(f"[sass] {name}: {len(code['parent'][name])} instructions, the change's "
                f"aligned=False instance {'the same' if equal else 'DIFFERENT'}")
        result["sass_same"] = same
        result["sass_missing"] = sorted(set(code["parent"]) - set(code["change"]))
        # K1: the float32 instance of the change's templated mask kernel, and
        # the scans, against the parent's
        k1 = {k: nms_sass(paths[t][2]) for k, t in trees.items()}
        k1_same = {name: k1["change"].get(name) == body for name, body in k1["parent"].items()}
        for name, equal in sorted(k1_same.items()):
            log(f"[sass] K1 {name}: {len(k1['parent'][name])} instructions, the change's "
                f"{'the same' if equal else 'DIFFERENT'}")
        result["k1_sass_same"] = k1_same
        runs = {k: [] for k in trees}
        for _ in range(args.rounds):
            for k in ("parent", "change", "change", "parent"):
                out = subprocess.run([sys.executable, __file__, "--parent", str(trees["parent"]),
                                      "--worker", str(trees[k])], check=True,
                                     capture_output=True, text=True, cwd=trees[k]).stdout
                runs[k].append(json.loads(out.strip().splitlines()[-1]))
        for case in runs["parent"][0]:
            log(f"[time] {case}: parent " + ", ".join(f"{r[case]:.4f}" for r in runs["parent"])
                + " ms; change " + ", ".join(f"{r[case]:.4f}" for r in runs["change"]) + " ms")
        result["ms"] = runs
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

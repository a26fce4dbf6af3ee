"""The host cost of the convolution epilogue's pass against the aten ops it
replaced (``ops/conv_epilogue.py``, ``models/precision.py::conv_bias_act``).

    python3 scripts/conv_epilogue_host.py [--calls 200] [--rounds 7]
        [--out chiprun_out/conv_epilogue_host.json]

At a small bf16 channels-last 1x1 convolution (1x64x8x8, so that the device
keeps up with the host), for each form of the pass (bias; bias and ReLU;
bias and the 2x nearest coarse add) it times the host microseconds a call
of

- ``ops``: the aten ops the pass replaced, over the convolution's output
  (``y.add_(bias)``, as aten adds a bias after cuDNN; then ``F.relu``, or
  ``+ F.interpolate(...)``), against ``conv_epilogue_cuda``, the wrapper
  and its launch alone;
- ``module``: the layer as the parent ran it (``conv(x)`` with its bias,
  then the same ops) against ``conv_bias_act`` under ``torch.no_grad()``;
  and the convolution without its bias alone.

Each is the least mean over ``--rounds`` rounds of ``--calls`` calls, the
functions in turn within a round and no synchronise inside one (the least,
since a shared host only ever adds time). Each side is then summed over
the passes of a bulk Mask R-CNN R-50-FPN predict call
(``chip_smoke.py::epilogue_passes``). Prints one JSON object and writes it
to ``--out``. Needs the card; it imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
os.environ.setdefault("CUDA_CACHE_PATH", str(CHECKOUT / "build" / "cuda_cache"))
sys.path.insert(0, str(CHECKOUT))

import torch  # noqa: E402
from torch.nn import functional as F  # noqa: E402

FORMS = ("bias", "relu", "coarse")


def host_us(fns: dict, calls: int, rounds: int) -> dict:
    """Host microseconds a call of each of ``fns``: the least mean over
    ``rounds`` rounds of ``calls`` calls."""
    best = dict.fromkeys(fns, float("inf"))
    for _ in range(rounds):
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best[name] = min(best[name], 1e6 * (time.perf_counter() - t0) / calls)
            torch.cuda.synchronize()
    return best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--out", default=str(CHECKOUT / "chiprun_out" / "conv_epilogue_host.json"))
    args = ap.parse_args(argv)

    from chip_smoke import MASK_R50, epilogue_passes
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.precision import Conv2d, conv_bias_act
    from detectron_tpu_torch.ops.conv_epilogue import conv_epilogue_cuda

    dev, dt, fmt = torch.device("cuda"), torch.bfloat16, torch.channels_last
    x = torch.randn((1, 64, 8, 8), device=dev, dtype=dt).contiguous(memory_format=fmt)
    up = torch.randn((1, 64, 4, 4), device=dev, dtype=dt).contiguous(memory_format=fmt)
    conv = Conv2d(64, 64, 1, compute_dtype=dt).to(dev)
    conv.memory_format = fmt
    with torch.no_grad():
        y, bias = conv.forward_unbiased(x)
    b4 = bias.reshape(1, -1, 1, 1)

    def tail(form, t):
        if form == "relu":
            return F.relu(t)
        return t + F.interpolate(up, scale_factor=2, mode="nearest") if form == "coarse" else t

    coarse = {"bias": None, "relu": None, "coarse": up}
    fns = {"conv without bias": lambda: conv.forward_unbiased(x)}
    for f in FORMS:
        fns[f"ops parent {f}"] = lambda f=f: tail(f, y.add_(b4))
        fns[f"ops new {f}"] = lambda f=f: conv_epilogue_cuda(y, bias, relu=f == "relu",
                                                             coarse=coarse[f])
        fns[f"module parent {f}"] = lambda f=f: tail(f, conv(x))
        fns[f"module new {f}"] = lambda f=f: conv_bias_act(conv, x, relu=f == "relu",
                                                           coarse=coarse[f])
    with torch.no_grad():
        read = host_us(fns, args.calls, args.rounds)
    passes = {f: 0 for f in FORMS}
    for _name, form, *_shape, count in epilogue_passes(get_config(MASK_R50, [])):
        passes[form] += count
    out = {"card": torch.cuda.get_device_name(), "torch": torch.__version__,
           "calls": args.calls, "rounds": args.rounds, "us": read, "passes": passes,
           "per_call_us": {f"{level} {side}": sum(passes[f] * read[f"{level} {side} {f}"]
                                                 for f in FORMS)
                           for level in ("ops", "module") for side in ("parent", "new")}}
    print(json.dumps(out))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out) + "\n")
    return out


if __name__ == "__main__":
    main()

"""The anchor matching kernels (``csrc/anchor_match.cu``) on the host.

The CUDA source, built with g++ against a host emulation that runs each
block's threads as real threads (``tests/cuda_thread_emulation.h``:
shared memory, ``__syncthreads``, the warp ballot and max reduction,
atomics), through :func:`anchor_match_cuda` with CPU tensors taken for CUDA
ones, equals the plain twin bit for bit at each of the matching cases of
``test_torch_losses_targets.py`` (which hold the twin against the JAX
package), with int32 and int64 classes; and counts two launches a call
with the force match, one without.
"""

import contextlib
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from detectron_tpu_torch import _build
from detectron_tpu_torch.layers import anchor_target as tat
from detectron_tpu_torch.ops import anchor_match as am
from test_torch_losses_targets import MATCH_CASES, match_case

HEADER = Path(__file__).resolve().parent / "cuda_thread_emulation.h"


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/anchor_match.cu`` built by g++ against the thread emulation:
    the CUDA include swapped for the header, each ``<<<...>>>`` launch for
    a call that runs the grid block by block."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ not found: the host emulation of csrc/anchor_match.cu needs it")
    src = (_build.CSRC / "anchor_match.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", f'#include "{HEADER}"')
    src, launches = re.subn(r"(\w+(?:<\w+>)?)<<<grid, block, 0, s>>>\(",
                            r"emulate_launch(\1, grid, block, ", src)
    assert launches == 3  # the per-gt pass and the match pass with and without the force
    out = tmp_path_factory.mktemp("anchor_match")
    (out / "anchor_match_host.cpp").write_text(src)
    proc = subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-o",
                           str(out / "anchor_match_host.so"), str(out / "anchor_match_host.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out / "anchor_match_host.so"))
    i32, i64, f32, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p
    lib.anchor_match.argtypes = [ptr] * 3 + [i32, i64, i32, i32] + [f32] * 5 + [i32] + [ptr] * 5
    lib.anchor_match.restype = i32
    return lib


@pytest.fixture
def on_host(emulated, monkeypatch):
    """The wrapper's CUDA route with CPU tensors taken for CUDA ones and the
    emulated library in place of the built one."""
    monkeypatch.setattr(am, "_anchor_match_lib", lambda: emulated)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_handle", lambda device: None)
    am.anchor_match_cuda.launches = 0
    return emulated


@pytest.mark.parametrize("classes", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", MATCH_CASES)
def test_kernel_on_the_host_equals_the_plain_twin(on_host, case, classes):
    anchors, gt, cls, kwargs = match_case(case)
    args = torch.tensor(anchors), torch.tensor(gt), torch.tensor(cls).to(classes)
    want = am.anchor_match_plain(*args, **kwargs)
    got = am.anchor_match_cuda(*args, **kwargs)
    for name, x, w in zip(("matched", "pos", "neg"), got, want):
        assert x.dtype == w.dtype and torch.equal(x, w), name
    assert am.anchor_match_cuda.launches == (2 if kwargs["force_match"] else 1)


def test_anchor_target_takes_the_kernel_on_cuda_tensors(on_host):
    """``anchor_target`` through the emulated kernel: the RPN's sample and
    targets equal the twin's, with two launches."""
    anchors, gt, cls, kwargs = match_case("no_gt_image")
    args = torch.tensor(anchors), torch.tensor(gt), torch.tensor(cls)
    noise = torch.rand((2, 3, len(anchors)), generator=torch.Generator().manual_seed(0))
    common = dict(pos_iou=0.7, neg_iou=0.3, sample_size=256)
    got = tat.anchor_target(*args, noise[0], noise[1], **common)
    assert am.anchor_match_cuda.launches == 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(am, "anchor_match", am.anchor_match_plain)
        want = tat.anchor_target(*args, noise[0], noise[1], **common)
    for name, x, w in zip(got._fields, got, want):
        assert torch.equal(x, w), name

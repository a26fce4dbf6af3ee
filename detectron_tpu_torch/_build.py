"""Builds the hand-written CUDA kernels under ``csrc/`` and loads them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/kernels/`` at the root of the checkout, at first use. The file
name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. The libraries are loaded
with ``ctypes``; every pointer and the stream go through as ``c_void_p``.
A failed build raises: nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
KERNELS = ("nms", "roi_align", "frozen_bn", "anchor_match", "conv_epilogue")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put it on PATH")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNELS) -> float:
    """Compiles every kernel in ``names`` whose library is missing, one
    ``nvcc`` process per source, all started together. Returns the
    seconds it took; raises ``RuntimeError`` with the compiler's output if
    any build fails. ``nvcc``'s report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside each library as ``.log``. A lock file in
    the build directory lets one process build at a time: processes
    started together (a data-parallel job's ranks) build each library
    once, and the others load it."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _build_missing(names)
    return time.perf_counter() - t0


def _build_missing(names) -> None:
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raises if a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current stream on CUDA ``device``, as the kernels take it:
    the raw handle, which the host reads in far less time than it builds a
    ``torch.cuda.Stream``."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))

"""The RLE mask codec of the port: ``rle.cpp``, built with ``g++`` at first
use and bound with ``ctypes``.

The port of ``detectron_tpu/native/__init__.py``, with the same ``RLE``
class, ``rle_iou`` and ``rle_merge``, plus ``rle_paste`` (the fused mask
paste + encode). The library is compiled into ``build/native/`` at the
root of the checkout, under a file name that carries a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. A failed build raises with the compiler's output: nothing
falls back. The numpy versions of the same functions (``*_plain``) are the
twins the tests hold the library against; the drivers never call them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "rle.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"rle-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles ``rle.cpp`` unless its library exists; returns the path.
    Raises ``RuntimeError`` with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the RLE codec (native/rle.cpp) needs it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"RLE codec build failed: g++ exited {proc.returncode}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders each write their own tmp
    return out


def load() -> ctypes.CDLL:
    """The loaded codec library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        lib.rle_encode.restype = i64
        lib.rle_encode.argtypes = [u8p, i64, i64, u32p]
        lib.rle_decode.restype = None
        lib.rle_decode.argtypes = [u32p, i64, i64, i64, u8p]
        lib.rle_area.restype = ctypes.c_uint64
        lib.rle_area.argtypes = [u32p, i64]
        lib.rle_iou.restype = None
        lib.rle_iou.argtypes = [u32p, i64p, i64p, i64, u32p, i64p, i64p, i64, u8p, f64p]
        lib.rle_merge.restype = i64
        lib.rle_merge.argtypes = [u32p, i64, u32p, i64, ctypes.c_int, u32p]
        lib.rle_paste.restype = i64
        lib.rle_paste.argtypes = [f32p, i64, f32p, i64, i64, ctypes.c_double, u32p]
        lib.rle_to_string.restype = i64
        lib.rle_to_string.argtypes = [u32p, i64, ctypes.c_char_p]
        lib.rle_from_string.restype = i64
        lib.rle_from_string.argtypes = [ctypes.c_char_p, i64, u32p]
        _lib = lib
        return lib


def have_native() -> bool:
    """Whether the codec builds and loads here (``detectron_tpu.native``'s
    query). The JAX package falls back to numpy where it does not; the
    port's functions raise instead, so this only asks."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


class RLE:
    """A single RLE mask: (h, w, counts uint32 array, column-major)."""

    __slots__ = ("h", "w", "counts")

    def __init__(self, h: int, w: int, counts: np.ndarray):
        self.h, self.w = int(h), int(w)
        self.counts = np.ascontiguousarray(counts, np.uint32)

    # -------------------------------------------------------------- codec
    @staticmethod
    def encode(mask: np.ndarray) -> "RLE":
        """mask: [H, W] bool/uint8 (row-major input; scanned column-major)."""
        h, w = mask.shape
        col = np.ascontiguousarray(mask.T.reshape(-1).astype(np.uint8))
        out = np.empty(h * w + 1, np.uint32)
        m = load().rle_encode(_ptr(col, ctypes.c_uint8), h, w, _ptr(out, ctypes.c_uint32))
        return RLE(h, w, out[:m].copy())

    @staticmethod
    def encode_plain(mask: np.ndarray) -> "RLE":
        """:meth:`encode` in numpy."""
        h, w = mask.shape
        col = np.ascontiguousarray(mask.T.reshape(-1).astype(np.uint8))
        diff = np.nonzero(np.diff(col))[0] + 1
        edges = np.concatenate([[0], diff, [col.size]])
        counts = np.diff(edges)
        if col.size and col[0] == 1:
            counts = np.concatenate([[0], counts])
        return RLE(h, w, counts.astype(np.uint32))

    def decode(self) -> np.ndarray:
        out = np.empty(self.h * self.w, np.uint8)
        load().rle_decode(_ptr(self.counts, ctypes.c_uint32), len(self.counts),
                          self.h, self.w, _ptr(out, ctypes.c_uint8))
        return out.reshape(self.w, self.h).T.astype(bool)

    def decode_plain(self) -> np.ndarray:
        """:meth:`decode` in numpy."""
        vals = np.zeros(len(self.counts), np.uint8)
        vals[1::2] = 1
        col = np.repeat(vals, self.counts)[: self.h * self.w]
        col = np.pad(col, (0, self.h * self.w - col.size))
        return col.reshape(self.w, self.h).T.astype(bool)

    def area(self) -> int:
        return int(load().rle_area(_ptr(self.counts, ctypes.c_uint32), len(self.counts)))

    def area_plain(self) -> int:
        """:meth:`area` in numpy."""
        return int(self.counts[1::2].sum())

    # ------------------------------------------------------------- string
    def to_string(self) -> str:
        buf = ctypes.create_string_buffer(6 * len(self.counts) + 1)
        n = load().rle_to_string(_ptr(self.counts, ctypes.c_uint32), len(self.counts), buf)
        return buf.raw[:n].decode("ascii")

    @staticmethod
    def from_string(s: str, h: int, w: int) -> "RLE":
        raw = s.encode("ascii")
        out = np.empty(len(raw) + 1, np.uint32)
        m = load().rle_from_string(raw, len(raw), _ptr(out, ctypes.c_uint32))
        return RLE(h, w, out[:m].copy())

    def to_coco(self) -> dict:
        """COCO results-JSON segmentation entry."""
        return {"size": [self.h, self.w], "counts": self.to_string()}


def rle_iou(a: list, b: list, iscrowd=None) -> np.ndarray:
    """Pairwise IoU between two lists of RLEs. iscrowd: per-b bool; a crowd
    column's IoU is intersection / area(a)."""
    na, nb = len(a), len(b)
    if na == 0 or nb == 0:
        return np.zeros((na, nb))
    ca = np.concatenate([x.counts for x in a]).astype(np.uint32)
    cb = np.concatenate([x.counts for x in b]).astype(np.uint32)
    la = np.array([len(x.counts) for x in a], np.int64)
    lb = np.array([len(x.counts) for x in b], np.int64)
    oa = np.concatenate([[0], np.cumsum(la)[:-1]]).astype(np.int64)
    ob = np.concatenate([[0], np.cumsum(lb)[:-1]]).astype(np.int64)
    crowd = np.asarray(iscrowd if iscrowd is not None else np.zeros(nb), np.uint8)
    out = np.empty(na * nb, np.float64)
    load().rle_iou(
        _ptr(ca, ctypes.c_uint32), _ptr(oa, ctypes.c_int64), _ptr(la, ctypes.c_int64), na,
        _ptr(cb, ctypes.c_uint32), _ptr(ob, ctypes.c_int64), _ptr(lb, ctypes.c_int64), nb,
        _ptr(crowd, ctypes.c_uint8), _ptr(out, ctypes.c_double))
    return out.reshape(na, nb)


def rle_iou_plain(a: list, b: list, iscrowd=None) -> np.ndarray:
    """:func:`rle_iou` on the decoded masks, in numpy."""
    out = np.zeros((len(a), len(b)), np.float64)
    ma = [x.decode_plain() for x in a]
    mb = [x.decode_plain() for x in b]
    crowd = np.zeros(len(b), bool) if iscrowd is None else np.asarray(iscrowd, bool)
    for i, x in enumerate(ma):
        sa = int(x.sum())
        for j, y in enumerate(mb):
            inter = int(np.logical_and(x, y).sum())
            denom = sa if crowd[j] else sa + int(y.sum()) - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


def rle_merge(a: RLE, b: RLE, intersect: bool = False) -> RLE:
    """Union (or, with ``intersect``, intersection) of two RLEs."""
    out = np.empty(len(a.counts) + len(b.counts) + 2, np.uint32)
    m = load().rle_merge(_ptr(a.counts, ctypes.c_uint32), len(a.counts),
                         _ptr(b.counts, ctypes.c_uint32), len(b.counts),
                         1 if intersect else 0, _ptr(out, ctypes.c_uint32))
    return RLE(a.h, a.w, out[:m].copy())


def rle_merge_plain(a: RLE, b: RLE, intersect: bool = False) -> RLE:
    """:func:`rle_merge` on the decoded masks, in numpy."""
    ma, mb = a.decode_plain(), b.decode_plain()
    return RLE.encode_plain(np.logical_and(ma, mb) if intersect else np.logical_or(ma, mb))


def rle_paste(mask: np.ndarray, box: np.ndarray, hw: tuple[int, int], threshold: float,
              buf: np.ndarray | None = None) -> RLE:
    """One detection's fused paste + encode: the ``[M, M]`` float32
    probabilities ``mask`` bilinearly resized into the float32 ``box``
    (x1, y1, x2, y2) on an ``hw`` canvas, thresholded, as a full-image RLE,
    in O(box area). ``buf``: a uint32 scratch of at least ``h * w + 1``
    entries to reuse across calls."""
    h, w = int(hw[0]), int(hw[1])
    mask = np.ascontiguousarray(mask, np.float32)
    box = np.ascontiguousarray(box, np.float32)
    if mask.ndim != 2 or mask.shape[0] != mask.shape[1] or box.shape != (4,):
        raise ValueError(f"mask {mask.shape} / box {box.shape}: want [M, M] and [4]")
    if buf is None or buf.dtype != np.uint32 or buf.size < h * w + 1:
        buf = np.empty(h * w + 1, np.uint32)
    n = load().rle_paste(_ptr(mask, ctypes.c_float), mask.shape[0],
                         _ptr(box, ctypes.c_float), h, w, float(threshold),
                         _ptr(buf, ctypes.c_uint32))
    return RLE(h, w, buf[:n].copy())

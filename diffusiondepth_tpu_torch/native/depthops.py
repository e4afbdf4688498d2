"""ctypes binding of ``depthops.cpp``, built at first use.

The library is compiled with the host C++ compiler (``$CXX``, else ``c++``
or ``g++``) into ``diffusiondepth_tpu_torch/_build/`` under a file name
that carries a hash of the source and the flags, so an edited source is
rebuilt rather than a stale library loaded. Nothing is built at import
time. Loader threads may call in at once: one lock guards the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "depthops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("c++"), shutil.which("g++")):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found (set CXX): depthops.cpp builds at first use")


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdepthops_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building depthops.cpp failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            fp = ctypes.POINTER(ctypes.c_float)
            u8 = ctypes.POINTER(ctypes.c_uint8)
            i64 = ctypes.c_int64
            lib.simple_depth_completion.argtypes = [fp, fp, i64, i64]
            lib.simple_depth_completion.restype = None
            lib.simple_depth_completion_batch.argtypes = [fp, fp, i64, i64, i64]
            lib.simple_depth_completion_batch.restype = None
            lib.png_unfilter.argtypes = [u8, i64, i64, i64, ctypes.c_int, u8]
            lib.png_unfilter.restype = ctypes.c_int
            lib.crc32c.argtypes = [ctypes.c_char_p, i64]
            lib.crc32c.restype = ctypes.c_uint32
            _lib = lib
    return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def simple_depth_completion(depth: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W) float32 depth with 0 == missing -> (filled, distance)."""
    canvas = np.ascontiguousarray(depth, np.float32).copy()
    dist = np.zeros_like(canvas)
    h, w = canvas.shape
    load().simple_depth_completion(_fp(canvas), _fp(dist), h, w)
    return canvas, dist


def simple_depth_completion_batch(depth: np.ndarray) -> np.ndarray:
    """(N, H, W) float32 -> filled (N, H, W)."""
    canvas = np.ascontiguousarray(depth, np.float32).copy()
    dist = np.zeros_like(canvas)
    n, h, w = canvas.shape
    load().simple_depth_completion_batch(_fp(canvas), _fp(dist), n, h, w)
    return canvas


def png_unfilter(raw: bytes, h: int, stride: int, bpp: int, sixteen: bool) -> np.ndarray:
    """The inflated IDAT stream of a non-interlaced PNG (a filter byte and
    ``stride`` bytes per row) -> (h, stride) uint8 rows, or (h, stride // 2)
    native uint16 samples when ``sixteen``."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {h * (stride + 1)}")
    buf = np.frombuffer(bytearray(raw), np.uint8)
    out = np.empty((h, stride // 2) if sixteen else (h, stride),
                   np.uint16 if sixteen else np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    rc = load().png_unfilter(buf.ctypes.data_as(u8), h, stride, bpp, int(sixteen),
                             out.ctypes.data_as(u8))
    if rc != 0:
        raise ValueError("PNG row with a filter type outside 0-4")
    return out


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    return load().crc32c(data, len(data))

"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``BUILD_DIR`` at first
use (the file name carries a hash of the source, the headers of ``csrc/``
and the flags, so an edited source or header is rebuilt) and loaded with
``ctypes``. Nothing here runs at import time: the CPU tests import every
module of the package on a machine without ``nvcc``.

``LAUNCHES`` counts kernel launches by kernel name. A wrapper adds one
exactly where it launches its kernel; calls that take the plain PyTorch
version (CPU tensors) add nothing. ``conv_link_xf`` counts the K1
launches that take its transform-warp path, which ``conv_link`` counts
too. ``H2D`` counts the copies of host data
to the card that the program makes, and their bytes: every such copy goes
through ``to_device``. Both are read per span by ``trace.py``. A constant
made on the host (a table, an index, a scale) is copied once per process,
through ``constant``. ``triton_module`` loads a Triton source of ``csrc/``
the same way, at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CUDA_SOURCES = ("conv_link", "window_attention", "conv_link_bwd", "window_attention_bwd",
                "window_attention_split", "layernorm_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

LAUNCHES: Dict[str, int] = {
    "conv_link": 0, "conv_link_xf": 0, "ddim_step": 0, "window_attention": 0,
    "sched_step": 0, "conv_link_bwd": 0, "sched_bwd": 0, "window_attention_bwd": 0,
    "window_attention_split": 0, "layernorm_fwd": 0, "layernorm_bwd": 0,
}

H2D: Dict[str, int] = {"h2d_copies": 0, "h2d_bytes": 0}

_CONSTANTS: Dict[Tuple, torch.Tensor] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_TRITON: Dict[str, object] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def to_device(data, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``data`` (an array, a number or a tensor) as a tensor of ``dtype``
    on ``device``: made on the host, then copied. A copy from the host to
    another device is counted in ``H2D``; a tensor already on a device
    stays there (cast to ``dtype``). For data that differs from call to
    call: a constant goes through ``constant``, a copy waits for the
    stream to drain."""
    host = torch.as_tensor(data, dtype=dtype)
    out = host.to(device)
    if host.device.type == "cpu" and out.device.type != "cpu":
        H2D["h2d_copies"] += 1
        H2D["h2d_bytes"] += out.nbytes
    return out


def constant(key: Tuple, make: Callable[[], object], device,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``make()`` (an array, a list, a number, or a tensor it makes on the
    device) as a tensor of ``dtype`` on ``device``, made and copied
    (``to_device``) once per (key, device, dtype) for the life of the
    process. ``key`` names everything the value depends on; callers treat
    the tensor as read-only. While a program is traced (``torch.export``)
    the value is made anew and not kept: a kept fake tensor would outlive
    the trace."""
    if torch.compiler.is_compiling():
        return to_device(make(), device, dtype)
    full = (key, torch.device(device), dtype)
    t = _CONSTANTS.get(full)
    if t is None:
        t = _CONSTANTS[full] = to_device(make(), device, dtype)
    return t


def no_autograd(kernel: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad: the raw
    kernel wrappers write their results through ``ctypes`` or Triton and
    return tensors without a ``grad_fn``, so a gradient would silently stop
    there. The ``torch.autograd.Function``s of ``ops/`` call them with grad
    mode off. The check runs for CPU tensors too, where the plain versions
    would differentiate, so that a CPU run shows the fault."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no autograd: call it under torch.no_grad or through its "
            "torch.autograd.Function (FusedDenoiser, FusedSamplerStep, WindowAttentionQKV, "
            "LayerNormBF16)")


def triton_module(name: str):
    """The module ``csrc/<name>.py`` (it imports triton), loaded at first
    use; Triton's compiled kernels go beside the CUDA builds."""
    mod = _TRITON.get(name)
    if mod is None:
        os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
        spec = importlib.util.spec_from_file_location(f"_{name}_triton", CSRC_DIR / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _TRITON[name] = mod
    return mod


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    """The library's path under ``BUILD_DIR``. Its name carries a hash of
    the source, of every header of ``csrc/`` (a source may include any of
    them) and of the compiler flags, so that an edit to any of them builds
    a new library."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _nvcc_cmd(name: str, out: Path) -> List[str]:
    return [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v",
            "-o", str(out), str(CSRC_DIR / f"{name}.cu")]


def build(names: Iterable[str] = CUDA_SOURCES) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together. Returns each
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check_device(t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on the CPU (the plain versions) or on a CUDA
    device (the kernels): a wrapper never runs a plain version elsewhere."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def check_tensors(kernel: str, expect, device) -> None:
    """Raise unless each (tensor, shape, dtype) of ``expect`` has that shape
    and type and lies contiguous on ``device``."""
    for t, shape, dt in expect:
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{kernel}: expected {dt} {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != device:
            raise ValueError(f"{kernel} inputs must be contiguous on one device")


def check_aligned(kernel: str, *tensors) -> None:
    """Raise unless each tensor's data starts on a 16-byte boundary, as the
    TMA loads of the conv kernels, the 16-byte cp.async rows of the bf16
    attention kernels and the 1-D bulk copies of K10 need."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{kernel} inputs must start on a 16-byte boundary")


def check(err: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError {err}")

"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The sources are compiled with nvcc at first use into a plain-C shared
library, keyed by a hash of the sources and flags, under
gcd_tpu_torch/_build/ (listed in .gitignore), and bound with ctypes. Each C
entry point launches on the stream it is given and returns
cudaGetLastError(); `launch` raises on a non-zero code. Nothing here runs
at import time, so the CPU tests import every module without nvcc or a card.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_attention.cu", "temporal_attention.cu", "fused_mlp.cu",
           "fused_norm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures: device pointers, then sizes, then the stream.
_SIGNATURES = {
    "gcd_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "gcd_temporal_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "gcd_geglu_mlp": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "gcd_group_stats": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I, _P),
    "gcd_group_norm": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _F, _I, _I,
                       _P),
    "gcd_group_stats_cl": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "gcd_group_norm_cl": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "gcd_tpu_torch/csrc/ with the CUDA toolkit")


def build() -> Tuple[Path, str]:
    """Compile csrc/ into the build directory unless an up-to-date library
    is already there: one nvcc per source, all started together, then one
    link. Returns (library path, the compilers' stderr -- the ptxas
    register/shared-memory report -- or "" when it was cached)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    out = BUILD_DIR / f"libgcdkernels-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(n).stem}-{tag}.o" for n in SOURCES]
    nvcc = _nvcc()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, obj in zip(SOURCES, objs)]
    reports = []
    for name, proc in zip(SOURCES, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n{err[-8000:]}")
        reports.append(err)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-8000:]}")
    os.replace(tmp, out)
    return out, "".join(reports)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.gcd_error_string.argtypes = [ctypes.c_int]
            lib.gcd_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point on the current CUDA stream; raise if the
    launch was refused."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(lib, name)(*args, stream)
    if code != 0:
        msg = lib.gcd_error_string(code).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {code} ({msg})")


def check_cuda_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                       shape: Tuple[int, ...], align: int = 16) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of the given dtype and
    shape whose data pointer is `align`-byte aligned."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")

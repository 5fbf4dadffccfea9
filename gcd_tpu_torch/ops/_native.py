"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The sources are compiled with nvcc at first use into a plain-C shared
library, keyed by a hash of the sources, the headers they share
(csrc/*.cuh) and the flags, under
gcd_tpu_torch/_build/ (listed in .gitignore), and bound with ctypes. Each C
entry point launches on the stream it is given and returns
cudaGetLastError(); `launch` raises on a non-zero code. Nothing here runs
at import time, so the CPU tests import every module without nvcc or a card.

The wgmma kernels (K1, K3, K6, K7) take TMA tensor maps, which the C entry points
encode with the driver's cuTensorMapEncodeTiled, keeping the last few
hundred by address and shape (the weights stay put, and the activations
come back to the same addresses). They find it
with dlopen/dlsym in the libcuda.so.1 that the CUDA runtime has loaded
(csrc/hopper.cuh), so the link needs no -lcuda.
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

from gcd_tpu_torch.native import build_lock

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "temporal_attention.cu",
           "fused_mlp.cu", "fused_norm.cu", "fused_gn_conv.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures: device pointers, then sizes, then the stream.
_SIGNATURES = {
    "gcd_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "gcd_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "gcd_temporal_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "gcd_geglu_mlp": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "gcd_group_stats": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I, _P),
    "gcd_group_norm": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _F, _I, _I,
                       _P),
    "gcd_group_stats_cl": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _F, _P),
    "gcd_group_norm_cl_onepass": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    "gcd_group_norm_cl": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
    "gcd_gn_silu_conv3x3": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _F, _I, _I, _I, _I, _I, _I, _P),
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
    link, under the build directory's lock (one build for the processes of a
    data-parallel run). Returns (library path, the compilers' stderr -- the
    ptxas register/shared-memory report -- or "" when it was cached)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [*(CSRC / name for name in SOURCES), *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"libgcdkernels-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    with build_lock(BUILD_DIR):
        if out.exists():  # built by another process while this one waited
            return out, ""
        return out, _compile(out, digest.hexdigest()[:16])


def _compile(out: Path, digest: str) -> str:
    tag = f"{digest}.{os.getpid()}"
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
    return "".join(reports)


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


def current_stream() -> Tuple[int, int]:
    """(device index, raw stream) of the current CUDA stream:
    torch.cuda.current_stream().cuda_stream without building a Stream object
    (about 10 us a call on the H100 machine's host)."""
    device = torch._C._cuda_getDevice()
    return device, torch._C._cuda_getCurrentRawStream(device)


def launch(name: str, *args) -> None:
    """Call one C entry point on the current CUDA stream; raise if the
    launch was refused."""
    lib = library()
    code = getattr(lib, name)(*args, current_stream()[1])
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


_scratch: dict = {}
_scratch_lock = threading.Lock()


def stream_scratch(tag: str, numel: int, dtype: torch.dtype, zeroed: bool = False) -> torch.Tensor:
    """A buffer of at least `numel` elements, kept per (tag, device, current
    stream) and reused by every call on that stream. Kernels on one stream
    run in order, so a call's scratch is free again when the next call's
    kernels start; another stream gets its own buffer. It grows to the
    largest size asked for. With `zeroed` it is zero when made, and the
    kernels that use it must leave it zero (K5's tickets)."""
    key = (tag, *current_stream())
    with _scratch_lock:
        buf = _scratch.get(key)
        if buf is None or buf.numel() < numel or buf.dtype != dtype:
            make = torch.zeros if zeroed else torch.empty
            buf = make(numel, dtype=dtype, device=torch.device("cuda", key[1]))
            _scratch[key] = buf
    return buf

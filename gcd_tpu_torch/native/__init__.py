"""The host renderer and PNG unfilter of the data pipeline (splat.cpp,
C++ / OpenMP; png.cpp, C++), bound with ctypes.

Each source is built with g++ at first use into gcd_tpu_torch/_build/
(listed in .gitignore), keyed by a hash of the source and the flags; nothing
is built at import. If a library cannot be built or loaded, every call
raises: there is no slower route in its place. The plain versions of the
same functions (data/geometry.py's splat and blur, data/png.py's
unfilter_plain) serve the tests and callers that ask for them by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "splat.cpp"
PNG_SOURCE = Path(__file__).resolve().parent / "png.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

_FP = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_png_lib: Optional[ctypes.CDLL] = None


def build(source: Path = SOURCE, stem: str = "libgcdsplat") -> Path:
    """Compile `source` unless an up-to-date library is already built;
    returns its path. Raises RuntimeError with the compiler's output if the
    build fails."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + source.read_bytes()).hexdigest()
    out = BUILD_DIR / f"{stem}-{digest[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(source), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot build the native {source.stem} with {CXX!r}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed on {source.name} ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.gcd_splat_points.restype = ctypes.c_int
            lib.gcd_splat_points.argtypes = [
                _FP, _FP, ctypes.c_int64,  # xyz, rgb, n
                _FP, _FP, ctypes.c_int,    # intrinsics 3x3, extrinsics, its columns
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # h, w, spread, pardom
                _FP, _FP,                  # out image, out weight (nullable)
            ]
            lib.gcd_blur_into_black.restype = ctypes.c_int
            lib.gcd_blur_into_black.argtypes = [_FP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_float]
            _lib = lib
        return _lib


def png_library() -> ctypes.CDLL:
    """The loaded PNG unfilter, built on first use."""
    global _png_lib
    with _lock:
        if _png_lib is None:
            lib = ctypes.CDLL(str(build(PNG_SOURCE, "libgcdpng")))
            lib.gcd_png_unfilter.restype = ctypes.c_int
            lib.gcd_png_unfilter.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                             _U8P]
            _png_lib = lib
        return _png_lib


def png_unfilter(data: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Reconstruct a PNG's decompressed image data (`height` rows of a
    filter-type byte and `row_bytes` bytes) with `bpp` bytes a pixel:
    (height, row_bytes) uint8. Raises ValueError on a filter type outside
    0-4."""
    lib = png_library()
    src = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    if src.size != height * (row_bytes + 1) or bpp < 1:
        raise ValueError(f"{src.size} bytes of image data for {height} rows of {row_bytes} "
                         f"bytes and {bpp} bytes a pixel")
    out = np.empty((height, row_bytes), dtype=np.uint8)
    rc = lib.gcd_png_unfilter(src.ctypes.data_as(_U8P), height, row_bytes, bpp,
                              out.ctypes.data_as(_U8P))
    if rc != 0:
        raise ValueError(f"row {rc - 1}: filter type {int(src[(rc - 1) * (row_bytes + 1)])} "
                         "is not one of PNG's five (0-4)")
    return out


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_FP)


def splat_points_native(xyz: np.ndarray, rgb: np.ndarray, intrinsics: np.ndarray,
                        extrinsics: np.ndarray, height: int, width: int,
                        spread_radius: int = 1, mode: str = "kubric") -> np.ndarray:
    """geometry.splat_points_to_image's image on unpadded inputs: (H, W, 3)
    float32 in [0, 1]."""
    lib = library()
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    rgb = np.ascontiguousarray(rgb, dtype=np.float32)
    intr = np.ascontiguousarray(intrinsics, dtype=np.float32)
    extr = np.ascontiguousarray(extrinsics, dtype=np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3 or rgb.shape != xyz.shape:
        raise ValueError(f"xyz {xyz.shape} and rgb {rgb.shape} must both be (N, 3)")
    if intr.shape != (3, 3) or extr.ndim != 2 or extr.shape[0] < 3 or extr.shape[1] < 4:
        raise ValueError(f"intrinsics {intr.shape} must be (3, 3), extrinsics {extr.shape} "
                         "at least (3, 4)")
    img = np.empty((height, width, 3), dtype=np.float32)
    rc = lib.gcd_splat_points(
        _fptr(xyz), _fptr(rgb), xyz.shape[0], _fptr(intr), _fptr(extr), extr.shape[1],
        height, width, spread_radius, 1 if mode == "pardom" else 0, _fptr(img), None)
    if rc != 0:
        raise RuntimeError(f"gcd_splat_points failed rc={rc}")
    return img


def blur_into_black_native(img: np.ndarray, kernel_size: int = 21) -> np.ndarray:
    """geometry.blur_into_black with sigma kernel_size / 4, in a copy."""
    lib = library()
    out = np.array(img, dtype=np.float32, order="C")
    if out.ndim != 3 or out.shape[2] != 3:
        raise ValueError(f"image {out.shape} must be (H, W, 3)")
    h, w = out.shape[:2]
    rc = lib.gcd_blur_into_black(_fptr(out), h, w, kernel_size, kernel_size / 4.0)
    if rc != 0:
        raise RuntimeError(f"gcd_blur_into_black failed rc={rc}")
    return out

"""jax.image.resize's "linear" and "cubic" methods, with its default
antialiasing, as separable fp32 products.

The weights are jax.image.scale_and_translate's (compute_weight_mat), scale
size_out / size_in and no translation: downsampling widens the kernel by
the inverse scale (the antialiasing low-pass), each output's weights are
normalised to sum to 1, and an output whose sample falls outside the input
gets none. The cubic kernel is Keys' with a = -0.5 (torch's bicubic uses
a = -0.75 and no low-pass). An axis whose size is unchanged is left as it
is, as jax.image.resize leaves it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), 1 - x)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def resize_weights(size_in: int, size_out: int, method: str = "linear") -> np.ndarray:
    """(size_in, size_out) float32 weights of one axis's resize."""
    inv_scale = 1.0 / (size_out / size_in)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample = (np.arange(size_out, dtype=np.float32) + 0.5) * np.float32(inv_scale) - 0.5
    x = np.abs(sample[None, :] - np.arange(size_in, dtype=np.float32)[:, None]) / kernel_scale
    weights = KERNELS[method](x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= size_in - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def resize(x: torch.Tensor, out_hw: Tuple[int, int], method: str = "linear") -> torch.Tensor:
    """(N, H, W, C) -> (N, h, w, C): jax.image.resize(x, (N, h, w, C),
    method) ("linear" is its "bilinear", "cubic" its "bicubic"), in fp32,
    returned in x's dtype."""
    (h, w), (oh, ow) = x.shape[1:3], out_hw
    out = x.float()
    if oh != h:
        wh = torch.from_numpy(resize_weights(h, oh, method)).to(x.device)
        out = torch.einsum("nhwc,hp->npwc", out, wh)
    if ow != w:
        ww = torch.from_numpy(resize_weights(w, ow, method)).to(x.device)
        out = torch.einsum("nhwc,wq->nhqc", out, ww)
    return out.to(x.dtype)

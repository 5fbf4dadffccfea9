"""Classifier-free guidance (port of gcd_tpu/diffusion/guiders.py).

A guider's `prepare_inputs(x, s, c, uc)` makes the batch the denoiser
evaluates and `__call__(out)` turns that evaluation into the denoised x.
The CFG guiders double the batch as cat([uc, c]), uc first.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gcd_tpu_torch.diffusion.denoiser import _append_dims

COND_KEYS = ("vector", "crossattn", "concat")


def _doubled(x: torch.Tensor, s: torch.Tensor, c: Dict, uc: Dict):
    cond = {k: torch.cat([uc[k], c[k]], dim=0) if k in COND_KEYS else c[k] for k in c}
    return torch.cat([x, x], dim=0), torch.cat([s, s], dim=0), cond


class IdentityGuider:
    """No guidance: the conditional batch alone, not doubled."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def prepare_inputs(self, x: torch.Tensor, s: torch.Tensor, c: Dict, uc: Dict):
        return x, s, dict(c)


class VanillaCFG:
    """One CFG scale for every frame: uc + scale * (c - uc)."""

    def __init__(self, scale: float):
        self.scale = float(scale)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x_u, x_c = x.chunk(2, dim=0)
        return x_u + self.scale * (x_c - x_u)

    def prepare_inputs(self, x: torch.Tensor, s: torch.Tensor, c: Dict, uc: Dict):
        return _doubled(x, s, c, uc)


class LinearPredictionGuider:
    """Per-frame CFG: scale linspace(min_scale, max_scale) over the T frames."""

    def __init__(self, max_scale: float, num_frames: int, min_scale: float = 1.0):
        self.num_frames = int(num_frames)
        self.scale = np.linspace(min_scale, max_scale, num_frames).astype(np.float32)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x_u, x_c = x.chunk(2, dim=0)
        t = self.num_frames
        shape = (x_u.shape[0] // t, t) + tuple(x_u.shape[1:])
        x_u, x_c = x_u.reshape(shape), x_c.reshape(shape)
        scale = _append_dims(torch.from_numpy(self.scale).to(x.device)[None], x_u.dim())
        out = x_u + scale.to(x_u.dtype) * (x_c - x_u)
        return out.reshape(x.shape[0] // 2, *x.shape[1:])

    def prepare_inputs(self, x: torch.Tensor, s: torch.Tensor, c: Dict, uc: Dict):
        return _doubled(x, s, c, uc)

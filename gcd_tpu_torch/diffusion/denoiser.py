"""Denoiser preconditioning transform (port of gcd_tpu/diffusion/denoiser.py)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from gcd_tpu_torch.utils.config import instantiate_from_config


def _append_dims(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.reshape(*x.shape, *([1] * (ndim - x.dim())))


class Denoiser:
    """D(x, sigma) = network(x * c_in, c_noise, cond) * c_out + x * c_skip.

    `rows`, when given, picks the rows of x that the network returns (a
    frame-sharded UNet returns its own frames' rows only,
    parallel/frames.py): D is then those rows of D(x, sigma)."""

    def __init__(self, scaling_config: Dict):
        self.scaling = instantiate_from_config(scaling_config)

    def __call__(self, network: Callable, x: torch.Tensor, sigma: torch.Tensor,
                 cond: Dict, rows: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> torch.Tensor:
        c_skip, c_out, c_in, c_noise = self.scaling(_append_dims(sigma, x.dim()))
        out = network(x * c_in, c_noise.reshape(sigma.shape), cond)
        if rows is not None:
            x, c_out, c_skip = rows(x), rows(c_out), rows(c_skip)
        return out.float() * c_out + x * c_skip

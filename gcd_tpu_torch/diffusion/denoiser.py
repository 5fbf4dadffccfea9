"""Denoiser preconditioning transform (port of gcd_tpu/diffusion/denoiser.py)."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from gcd_tpu_torch.utils.config import instantiate_from_config


def _append_dims(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.reshape(*x.shape, *([1] * (ndim - x.dim())))


class Denoiser:
    """D(x, sigma) = network(x * c_in, c_noise, cond) * c_out + x * c_skip."""

    def __init__(self, scaling_config: Dict):
        self.scaling = instantiate_from_config(scaling_config)

    def __call__(self, network: Callable, x: torch.Tensor, sigma: torch.Tensor,
                 cond: Dict) -> torch.Tensor:
        c_skip, c_out, c_in, c_noise = self.scaling(_append_dims(sigma, x.dim()))
        out = network(x * c_in, c_noise.reshape(sigma.shape), cond)
        return out.float() * c_out + x * c_skip

"""Euler EDM sampler (port of gcd_tpu/diffusion/sampling.py).

The JAX lax.scan becomes a Python loop over the numpy sigma ladder; the
initial noise is passed in, and s_churn = 0 draws no per-step noise.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from gcd_tpu_torch.diffusion.denoiser import _append_dims
from gcd_tpu_torch.utils.config import instantiate_from_config


class EulerEDMSampler:
    """Plain Euler over the EDM sigma ladder, the sampler of every released
    GCD model."""

    def __init__(self, discretization_config: Dict, guider_config: Dict,
                 num_steps: Optional[int] = None, s_churn: float = 0.0,
                 verbose: bool = False):
        if s_churn:
            raise NotImplementedError("s_churn > 0 draws per-step noise; the port "
                                      "samples with noise passed in")
        self.num_steps = num_steps
        self.discretization = instantiate_from_config(discretization_config)
        self.guider = instantiate_from_config(guider_config)

    def __call__(self, denoiser: Callable, x: torch.Tensor, cond: Dict, uc: Dict,
                 num_steps: Optional[int] = None) -> torch.Tensor:
        """`denoiser(x, sigma, cond) -> denoised` on the CFG-doubled batch;
        x is the initial unit-variance noise."""
        sigmas = self.discretization(num_steps or self.num_steps)
        x = x * float(np.sqrt(1.0 + sigmas[0] ** 2))
        s_in = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
        for sigma, next_sigma in zip(sigmas[:-1], sigmas[1:]):
            sig = s_in * float(sigma)
            x_in, s_2, c_in = self.guider.prepare_inputs(x, sig, cond, uc)
            denoised = self.guider(denoiser(x_in, s_2, c_in))
            d = (x - denoised) / _append_dims(sig, x.dim())
            x = x + _append_dims(s_in * float(next_sigma) - sig, x.dim()) * d
        return x

"""Euler EDM sampler (port of gcd_tpu/diffusion/sampling.py).

The JAX lax.scan becomes a Python loop over the numpy sigma ladder, each
iteration one `step` with the step's sigmas as 0-d tensors (the step an
exported sampler runs, engine/export.py); the initial noise is passed in,
and s_churn = 0 draws no per-step noise. With a
`guidance_interval` (lo, hi), the choice between the guided step and the
plain conditional one is a Python `if` on the step's ladder sigma, known
before the loop starts: no device sync, nothing like lax.cond.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from gcd_tpu_torch.diffusion.denoiser import _append_dims
from gcd_tpu_torch.utils.config import instantiate_from_config


class EulerEDMSampler:
    """Plain Euler over the EDM sigma ladder, the sampler of every released
    GCD model.

    guidance_interval=(lo, hi) applies CFG only at the steps whose sigma is
    in [lo, hi] and runs the bare conditional branch, at half the UNet
    batch, at the others (Kynkaanniemi et al. 2024, "Applying Guidance in a
    Limited Interval", arXiv:2404.07724). None, the default, is exact CFG at
    every step, the reference protocol."""

    def __init__(self, discretization_config: Dict, guider_config: Dict,
                 num_steps: Optional[int] = None, s_churn: float = 0.0,
                 verbose: bool = False, guidance_interval: Optional[Sequence[float]] = None):
        if s_churn:
            raise NotImplementedError("s_churn > 0 draws per-step noise; the port "
                                      "samples with noise passed in")
        self.num_steps = num_steps
        self.discretization = instantiate_from_config(discretization_config)
        self.guider = instantiate_from_config(guider_config)
        self.guidance_interval = None
        if guidance_interval is not None:
            lo, hi = (float(v) for v in guidance_interval)
            if not lo <= hi:
                raise ValueError(f"guidance_interval ({lo}, {hi}): lo must not exceed hi")
            self.guidance_interval = (lo, hi)

    def sigmas(self, num_steps: Optional[int] = None) -> np.ndarray:
        """The ladder, float32, with the final 0."""
        return self.discretization(num_steps or self.num_steps)

    def guided_steps(self, num_steps: Optional[int] = None) -> List[bool]:
        """Per step, whether it applies CFG: its sigma inside the interval,
        compared in float32 as the JAX sampler compares it."""
        steps = self.sigmas(num_steps)[:-1]
        if self.guidance_interval is None:
            return [True] * len(steps)
        lo, hi = (np.float32(v) for v in self.guidance_interval)
        return [bool(lo <= s <= hi) for s in steps]

    def step(self, denoiser: Callable, x: torch.Tensor, sigma: torch.Tensor,
             next_sigma: torch.Tensor, cond: Dict, uc: Dict, guided: bool) -> torch.Tensor:
        """One Euler step of x from `sigma` to `next_sigma`, 0-d fp32 tensors
        (the loop's and an exported step program's one definition):
        `denoiser(x, sigma, cond) -> denoised` on the CFG-doubled batch when
        `guided`, on x's own batch otherwise."""
        s_in = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
        sig = s_in * sigma
        if guided:
            x_in, s_2, c_in = self.guider.prepare_inputs(x, sig, cond, uc)
            denoised = self.guider(denoiser(x_in, s_2, c_in))
        else:
            denoised = denoiser(x, sig, cond)
        d = (x - denoised) / _append_dims(sig, x.dim())
        return x + _append_dims(s_in * next_sigma - sig, x.dim()) * d

    def __call__(self, denoiser: Callable, x: torch.Tensor, cond: Dict, uc: Dict,
                 num_steps: Optional[int] = None) -> torch.Tensor:
        """`step` over the ladder; x is the initial unit-variance noise."""
        sigmas = self.sigmas(num_steps)
        x = x * float(np.sqrt(1.0 + sigmas[0] ** 2))
        ladder = torch.from_numpy(sigmas).to(x.device)
        for i, guided in enumerate(self.guided_steps(num_steps)):
            x = self.step(denoiser, x, ladder[i], ladder[i + 1], cond, uc, guided)
        return x

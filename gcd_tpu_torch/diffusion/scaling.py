"""EDM denoiser preconditioning (port of gcd_tpu/diffusion/scaling.py)."""

from __future__ import annotations

import torch


class VScalingWithEDMcNoise:
    """v-parameterisation scales with the EDM 0.25*log(sigma) noise input."""

    def __call__(self, sigma: torch.Tensor):
        c_skip = 1.0 / (sigma ** 2 + 1.0)
        c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        c_noise = 0.25 * torch.log(sigma)
        return c_skip, c_out, c_in, c_noise

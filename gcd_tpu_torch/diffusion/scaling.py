"""Denoiser preconditioning (port of gcd_tpu/diffusion/scaling.py).

Each scaling maps sigma to (c_skip, c_out, c_in, c_noise), so that
D(x, sigma) = network(x * c_in, c_noise, cond) * c_out + x * c_skip.
"""

from __future__ import annotations

import torch


class EDMScaling:
    def __init__(self, sigma_data: float = 0.5):
        self.sigma_data = float(sigma_data)

    def __call__(self, sigma: torch.Tensor):
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (sigma ** 2 + sd2)
        c_out = sigma * self.sigma_data / torch.sqrt(sigma ** 2 + sd2)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + sd2)
        c_noise = 0.25 * torch.log(sigma)
        return c_skip, c_out, c_in, c_noise


class EpsScaling:
    def __call__(self, sigma: torch.Tensor):
        c_skip = torch.ones_like(sigma)
        c_out = -sigma
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        c_noise = sigma
        return c_skip, c_out, c_in, c_noise


class VScaling:
    def __call__(self, sigma: torch.Tensor):
        c_skip = 1.0 / (sigma ** 2 + 1.0)
        c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        c_noise = sigma
        return c_skip, c_out, c_in, c_noise


class VScalingWithEDMcNoise:
    """v-parameterisation scales with the EDM 0.25*log(sigma) noise input."""

    def __call__(self, sigma: torch.Tensor):
        c_skip = 1.0 / (sigma ** 2 + 1.0)
        c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        c_noise = 0.25 * torch.log(sigma)
        return c_skip, c_out, c_in, c_noise


class DumbScaling:
    def __call__(self, sigma: torch.Tensor):
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        c_noise = 0.25 * torch.log(sigma)
        c_skip = torch.zeros_like(sigma)
        c_out = torch.ones_like(sigma)
        return c_skip, c_out, c_in, c_noise

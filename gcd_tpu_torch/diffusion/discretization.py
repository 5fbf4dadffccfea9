"""Sigma ladders (port of gcd_tpu/diffusion/discretization.py), numpy.

A discretization's `__call__(n, do_append_zero, flip)` is the ladder of n
sigmas in float32, the final 0 appended and the order flipped on request.
"""

from __future__ import annotations

import numpy as np


def generate_roughly_equally_spaced_steps(num_substeps: int, max_step: int) -> np.ndarray:
    return np.linspace(max_step - 1, 0, num_substeps, endpoint=False).astype(int)[::-1]


class Discretization:
    def __call__(self, n: int, do_append_zero: bool = True, flip: bool = False) -> np.ndarray:
        sigmas = np.asarray(self.get_sigmas(n), dtype=np.float32)
        if do_append_zero:
            sigmas = np.concatenate([sigmas, np.zeros((1,), np.float32)])
        return sigmas[::-1].copy() if flip else sigmas

    def get_sigmas(self, n: int) -> np.ndarray:
        raise NotImplementedError


class EDMDiscretization(Discretization):
    """Karras rho-schedule; GCD configs use sigma_max = 700."""

    def __init__(self, sigma_min: float = 0.002, sigma_max: float = 80.0,
                 rho: float = 7.0):
        self.sigma_min, self.sigma_max, self.rho = float(sigma_min), float(sigma_max), float(rho)

    def get_sigmas(self, n: int) -> np.ndarray:
        ramp = np.linspace(0, 1, n, dtype=np.float64)
        lo, hi = self.sigma_min ** (1 / self.rho), self.sigma_max ** (1 / self.rho)
        return ((hi + ramp * (lo - hi)) ** self.rho).astype(np.float32)


class LegacyDDPMDiscretization(Discretization):
    """The DDPM ladder: betas linear in sqrt space (float64), their
    cumulative alphas at n roughly equally spaced timesteps, as sigmas
    sqrt((1 - a) / a), descending."""

    def __init__(self, linear_start: float = 0.00085, linear_end: float = 0.0120,
                 num_timesteps: int = 1000):
        self.num_timesteps = int(num_timesteps)
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, num_timesteps,
                            dtype=np.float64) ** 2
        self.alphas_cumprod = np.cumprod(1.0 - betas, axis=0)

    def get_sigmas(self, n: int) -> np.ndarray:
        if n < self.num_timesteps:
            timesteps = generate_roughly_equally_spaced_steps(n, self.num_timesteps)
            alphas_cumprod = self.alphas_cumprod[timesteps]
        elif n == self.num_timesteps:
            alphas_cumprod = self.alphas_cumprod
        else:
            raise ValueError(f"n={n} > num_timesteps={self.num_timesteps}")
        sigmas = ((1 - alphas_cumprod) / alphas_cumprod) ** 0.5
        return sigmas[::-1].astype(np.float32)

"""Sigma ladder (port of gcd_tpu/diffusion/discretization.py), numpy."""

from __future__ import annotations

import numpy as np


class EDMDiscretization:
    """Karras rho-schedule; GCD configs use sigma_max = 700."""

    def __init__(self, sigma_min: float = 0.002, sigma_max: float = 80.0,
                 rho: float = 7.0):
        self.sigma_min, self.sigma_max, self.rho = float(sigma_min), float(sigma_max), float(rho)

    def __call__(self, n: int, do_append_zero: bool = True, flip: bool = False) -> np.ndarray:
        ramp = np.linspace(0, 1, n, dtype=np.float64)
        lo, hi = self.sigma_min ** (1 / self.rho), self.sigma_max ** (1 / self.rho)
        sigmas = ((hi + ramp * (lo - hi)) ** self.rho).astype(np.float32)
        if do_append_zero:
            sigmas = np.concatenate([sigmas, np.zeros((1,), np.float32)])
        return sigmas[::-1].copy() if flip else sigmas

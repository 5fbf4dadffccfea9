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

    def possibly_quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma

    def possibly_quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        return c_noise

    def __call__(self, network: Callable, x: torch.Tensor, sigma: torch.Tensor,
                 cond: Dict, rows: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> torch.Tensor:
        sigma = self.possibly_quantize_sigma(sigma)
        c_skip, c_out, c_in, c_noise = self.scaling(_append_dims(sigma, x.dim()))
        c_noise = self.possibly_quantize_c_noise(c_noise.reshape(sigma.shape))
        out = network(x * c_in, c_noise, cond)
        if rows is not None:
            x, c_out, c_skip = rows(x), rows(c_out), rows(c_skip)
        return out.float() * c_out + x * c_skip


class DiscreteDenoiser(Denoiser):
    """A Denoiser whose sigma is snapped to the nearest rung of a fixed
    ladder of `num_idx` sigmas, and whose noise input is, with
    `quantize_c_noise`, the index of the rung nearest the scaling's c_noise
    (as float32)."""

    def __init__(self, scaling_config: Dict, num_idx: int, discretization_config: Dict,
                 do_append_zero: bool = False, quantize_c_noise: bool = True,
                 flip: bool = True):
        super().__init__(scaling_config)
        discretization = instantiate_from_config(discretization_config)
        self.sigmas = discretization(num_idx, do_append_zero=do_append_zero, flip=flip)
        self.quantize_c_noise = quantize_c_noise
        self.num_idx = num_idx
        self._ladders: Dict[torch.device, torch.Tensor] = {}

    def _ladder(self, device: torch.device) -> torch.Tensor:
        if device not in self._ladders:
            self._ladders[device] = torch.from_numpy(self.sigmas).to(device)
        return self._ladders[device]

    def sigma_to_idx(self, sigma: torch.Tensor) -> torch.Tensor:
        """The index of the rung nearest each sigma (the first of a tie)."""
        dists = sigma.reshape(-1) - self._ladder(sigma.device)[:, None]
        return dists.abs().argmin(dim=0).reshape(sigma.shape)

    def idx_to_sigma(self, idx: torch.Tensor) -> torch.Tensor:
        return self._ladder(idx.device)[idx]

    def possibly_quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return self.idx_to_sigma(self.sigma_to_idx(sigma))

    def possibly_quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        if self.quantize_c_noise:
            return self.sigma_to_idx(c_noise).float()
        return c_noise

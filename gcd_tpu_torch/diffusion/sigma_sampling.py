"""Training-time sigma samplers (port of gcd_tpu/diffusion/sigma_sampling.py).

Each takes its random numbers as an explicit `rand`, or draws them from a
torch.Generator. GCD trains with EDMSampling(p_mean=1.0, p_std=1.6).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gcd_tpu_torch.utils.config import instantiate_from_config


class EDMSampling:
    """sigma = exp(p_mean + p_std * rand), rand a unit Gaussian (n,)."""

    def __init__(self, p_mean: float = -1.2, p_std: float = 1.2):
        self.p_mean, self.p_std = float(p_mean), float(p_std)

    def draw(self, n: int, generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
        return torch.randn(n, generator=generator, device=device)

    def __call__(self, rand: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.p_mean + self.p_std * rand.float())


class DiscreteSampling:
    """sigma = the discretization's ladder at uniform integer indices rand
    in [0, num_idx)."""

    def __init__(self, discretization_config: Dict, num_idx: int,
                 do_append_zero: bool = False, flip: bool = True):
        self.num_idx = int(num_idx)
        self.sigmas = torch.from_numpy(instantiate_from_config(discretization_config)(
            num_idx, do_append_zero=do_append_zero, flip=flip))

    def draw(self, n: int, generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
        return torch.randint(0, self.num_idx, (n,), generator=generator, device=device)

    def __call__(self, rand: torch.Tensor) -> torch.Tensor:
        return self.sigmas.to(rand.device)[rand.long()]

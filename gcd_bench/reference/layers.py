"""Plain PyTorch building blocks of the reference.

Every matrix product of the models goes through `QLinear`, `QConv2d` or
`QConv3d`, whose `quant` is None for the reference (float32, TF32 off) and a
fake-quantiser for the lower-precision control (`fp8_e4m3`): the weight and
the input of each product rounded to float8 e4m3 with one absmax scale per
tensor, the product itself in float32. Normalisations, softmax and the
attention products stay in float32 in both.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one absmax scale, returned in x's
    dtype; the gradient passes through the rounding unchanged."""
    xd = x.detach()
    scale = xd.abs().amax().clamp_min(1e-30) / FP8_MAX
    rounded = (xd / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (rounded - xd)


def set_quant(module: nn.Module, quant: Quant) -> nn.Module:
    """Give every product layer of `module` the quantiser `quant`."""
    for m in module.modules():
        if isinstance(m, Quantised):
            m.quant = quant
    return module


def _q(quant: Quant, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return t if quant is None or t is None else quant(t)


class Quantised:
    """A layer whose products take their operands through `quant`."""

    quant: Quant = None

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return _q(self.quant, t)


class QLinear(Quantised, nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class QConv2d(Quantised, nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(self.q(x), self.q(self.weight), self.bias)


class QConv3d(Quantised, nn.Conv3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(self.q(x), self.q(self.weight), self.bias)


class GroupNorm(nn.Module):
    """GroupNorm(32) with an optional SiLU; parameters `weight` and `bias`."""

    def __init__(self, channels: int, eps: float = 1e-5, silu: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps, self.silu = eps, silu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x, 32, self.weight, self.bias, self.eps)
        return F.silu(y) if self.silu else y


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over the last two axes."""
    w = torch.softmax(q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5, dim=-1)
    return w @ v


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin], of (N,) -> (N, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def mlp(c_in: int, c_hidden: int, c_out: int) -> nn.Sequential:
    """Linear - SiLU - Linear under the keys 0 and 2."""
    return nn.Sequential(QLinear(c_in, c_hidden), nn.SiLU(), QLinear(c_hidden, c_out))

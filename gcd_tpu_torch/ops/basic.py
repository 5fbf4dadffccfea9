"""Basic tensor ops shared across models (port of gcd_tpu/ops/basic.py)."""

from __future__ import annotations

import math

import torch


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings, [cos | sin] order, fp32. (N,) -> (N, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      / half)
    args = timesteps[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb

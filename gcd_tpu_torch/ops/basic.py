"""Basic tensor ops shared across models (port of gcd_tpu/ops/basic.py)."""

from __future__ import annotations

import math
from typing import Optional

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


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """(..., Sq, D) x (..., Sk, D) -> (..., Sq, D) in v's dtype: fp32 logits
    and softmax, weights cast to v's dtype for the PV product, fp32
    accumulation (gcd_tpu/ops/attention.py:_xla_attention). The attention of
    heads that no kernel takes (the VAE's width-512 head, CLIP's width-80
    heads)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights.float(), v.float()).to(v.dtype)

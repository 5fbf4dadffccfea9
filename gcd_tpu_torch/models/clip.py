"""OpenCLIP ViT-H/14 image tower and its preprocessing (port of
gcd_tpu/models/clip.py).

Architecture (open_clip ViT-H/14): patch 14, width 1280, 32 layers, 16 heads,
MLP ratio 4 with exact erf GELU, pre-LN transformer, cls-token pooling, final
LayerNorm and projection to 1024. Parameter names are open_clip's
(conv1, class_embedding, positional_embedding, ln_pre,
transformer.resblocks.N.{ln_1, attn.in_proj_weight, attn.in_proj_bias,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}, ln_post, proj), so the
checkpoints' conditioner.embedders.0.open_clip.model.visual.* keys load.

The head width is 1280 / 16 = 80, which K1 does not take (the JAX package
never sends this attention to its flash kernel either): attention is plain
matmuls with an fp32 softmax (ops/basic.py dot_product_attention).

Preprocessing reproduces kornia.geometry.resize to 224 (bicubic,
align_corners=True, antialias=True: a separable gaussian pre-blur, then torch
bicubic with A = -0.75), [-1, 1] -> [0, 1] and CLIP's mean/std. Both stages
are linear with a fixed target, so they fold into one (224, H) and one
(224, W) matrix, built in numpy once per input size.
"""

from __future__ import annotations

from collections import OrderedDict
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gcd_tpu_torch.models.layers import LayerNormFp32
from gcd_tpu_torch.ops.basic import dot_product_attention

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class MHA(nn.Module):
    """torch.nn.MultiheadAttention's parameters (combined in_proj, out_proj),
    self-attention only. x (B, S, C)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(b, s, self.heads, c // self.heads).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        out = dot_product_attention(q, k, v)  # (B, H, S, D)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, c))


class CLIPBlock(nn.Module):
    """Pre-LN residual attention block: x + attn(ln_1(x)), then
    x + mlp(ln_2(x)) with exact GELU."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNormFp32(width)
        self.attn = MHA(width, heads)
        self.ln_2 = LayerNormFp32(width)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width)), ("gelu", nn.GELU()),
            ("c_proj", nn.Linear(4 * width, width))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(CLIPBlock(width, heads) for _ in range(layers))


class CLIPVisionTower(nn.Module):
    """ViT image encoder: (N, 3, image_size, image_size) CLIP-normalised ->
    the projected cls embedding (N, output_dim)."""

    def __init__(self, width: int = 1280, layers: int = 32, heads: int = 16,
                 patch_size: int = 14, image_size: int = 224, output_dim: int = 1024):
        super().__init__()
        grid = image_size // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, width))
        self.ln_pre = LayerNormFp32(width)
        self.transformer = _Transformer(width, layers, heads)
        self.ln_post = LayerNormFp32(width)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x.to(self.conv1.weight.dtype)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(h.dtype).expand(h.shape[0], 1, -1)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding.to(h.dtype)
        h = self.ln_pre(h)
        for block in self.transformer.resblocks:
            h = block(h)
        return self.ln_post(h)[:, 0] @ self.proj.to(h.dtype)


def _cubic_kernel(d: np.ndarray, a: float = -0.75) -> np.ndarray:
    """torch's cubic convolution (aten UpSample.h, A = -0.75) at distances d."""
    ad = np.abs(d)
    near = ((a + 2.0) * ad - (a + 3.0)) * ad * ad + 1.0
    far = (((a * ad - 5.0 * a) * ad + 8.0 * a) * ad) - 4.0 * a
    return np.where(ad <= 1.0, near, np.where(ad < 2.0, far, 0.0))


def _bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix of torch bicubic with align_corners=True: source
    positions dst*(in-1)/(out-1), 4 taps clamped to the border."""
    if out_size == 1:
        src = np.zeros((1,), np.float32)
    else:
        # torch computes the source position in float32; float64 here would
        # move it by ~1e-8 px, which steep images turn into ~5e-5 differences.
        scale = np.float32(in_size - 1) / np.float32(out_size - 1)
        src = np.arange(out_size, dtype=np.float32) * scale
    x0 = np.floor(src).astype(np.int64)
    t = (src - x0.astype(np.float32)).astype(np.float64)
    mat = np.zeros((out_size, in_size))
    rows = np.arange(out_size)
    for k in range(-1, 3):
        idx = np.clip(x0 + k, 0, in_size - 1)
        np.add.at(mat, (rows, idx), _cubic_kernel(t - k))
    return mat


def _gaussian_blur_matrix(size: int, sigma: float) -> np.ndarray:
    """(size, size) matrix of kornia.filters.gaussian_blur2d along one axis:
    odd kernel of width max(4*sigma, 3), reflect ('reflect101') padding."""
    ks = int(max(2.0 * 2.0 * sigma, 3.0))
    if ks % 2 == 0:
        ks += 1
    xs = np.arange(ks) - ks // 2
    g = np.exp(-(xs.astype(np.float64) ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    mat = np.zeros((size, size))
    rows = np.arange(size)
    for j in range(ks):
        idx = rows + (j - ks // 2)
        idx = np.where(idx < 0, -idx, idx)
        idx = np.where(idx >= size, 2 * (size - 1) - idx, idx)
        np.add.at(mat, (rows, idx), g[j])
    return mat


@lru_cache(maxsize=64)
def _kornia_resize_matrices(in_h: int, in_w: int, out_h: int, out_w: int,
                            antialias: bool):
    """Per-axis (out, in) float32 matrices reproducing kornia.geometry.resize:
    gaussian pre-blur folded into corner-aligned bicubic. Kornia blurs both
    axes whenever max(in/out) > 1, with the per-axis sigma floored at 0.001
    (about the identity for an upscaling axis)."""
    my = _bicubic_matrix(in_h, out_h)
    mx = _bicubic_matrix(in_w, out_w)
    fy, fx = in_h / out_h, in_w / out_w
    if antialias and max(fy, fx) > 1.0:
        my = my @ _gaussian_blur_matrix(in_h, max((fy - 1.0) / 2.0, 0.001))
        mx = mx @ _gaussian_blur_matrix(in_w, max((fx - 1.0) / 2.0, 0.001))
    return my.astype(np.float32), mx.astype(np.float32)


def clip_preprocess(x: torch.Tensor, image_size: int = 224,
                    antialias: bool = True) -> torch.Tensor:
    """(N, 3, H, W) in [-1, 1] -> (N, 3, image_size, image_size)
    CLIP-normalised, fp32."""
    _, _, h, w = x.shape
    x = x.float()
    if (h, w) != (image_size, image_size):
        my, mx = _kornia_resize_matrices(h, w, image_size, image_size, antialias)
        x = torch.einsum("oh,nchw->ncow", torch.from_numpy(my).to(x.device), x)
        x = torch.einsum("pw,nchw->nchp", torch.from_numpy(mx).to(x.device), x)
    mean = torch.tensor(CLIP_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).reshape(1, 3, 1, 1)
    return ((x + 1.0) / 2.0 - mean) / std

"""Plain float32 OpenCLIP ViT image tower with its preprocessing.

Preprocessing is kornia's antialiased resize as sgm's
FrozenOpenCLIPImageEmbedder calls it: a Gaussian blur (sigma (s - 1) / 2 per
axis for a shrink factor s, an odd kernel of width max(4 sigma, 3),
reflected borders), then a corner-aligned bicubic resize to 224 x 224, then
CLIP's normalisation of the [0, 1] image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gcd_bench.reference.layers import QConv2d, QLinear, Quantised, attention

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def _blur_axis(x: torch.Tensor, sigma: float, axis: int) -> torch.Tensor:
    ks = int(max(4.0 * sigma, 3.0))
    ks += 1 - ks % 2
    r = torch.arange(ks, dtype=torch.float64) - ks // 2
    g = torch.exp(-r ** 2 / (2.0 * sigma ** 2))
    g = (g / g.sum()).to(x.dtype).to(x.device)
    c = x.shape[1]
    if axis == 2:
        x = F.pad(x, (0, 0, ks // 2, ks // 2), mode="reflect")
        return F.conv2d(x, g.reshape(1, 1, ks, 1).expand(c, 1, ks, 1), groups=c)
    x = F.pad(x, (ks // 2, ks // 2, 0, 0), mode="reflect")
    return F.conv2d(x, g.reshape(1, 1, 1, ks).expand(c, 1, 1, ks), groups=c)


def preprocess(frames: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W, 3) in [-1, 1] -> (N, 3, size, size) CLIP-normalised."""
    x = frames.permute(0, 3, 1, 2).float()
    h, w = x.shape[2:]
    if (h, w) != (size, size):
        fy, fx = h / size, w / size
        if max(fy, fx) > 1.0:
            x = _blur_axis(x, max((fy - 1.0) / 2.0, 0.001), 2)
            x = _blur_axis(x, max((fx - 1.0) / 2.0, 0.001), 3)
        x = F.interpolate(x, size=(size, size), mode="bicubic", align_corners=True)
    mean = torch.tensor(MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).reshape(1, 3, 1, 1)
    return ((x + 1.0) / 2.0 - mean) / std


class Attention(Quantised, nn.Module):
    """nn.MultiheadAttention's parameters: in_proj (q | k | v) and out_proj."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = QLinear(width, width)

    def forward(self, x):
        b, s, c = x.shape
        qkv = F.linear(self.q(x), self.q(self.in_proj_weight), self.in_proj_bias)
        q, k, v = (t.reshape(b, s, self.heads, c // self.heads).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        return self.out_proj(attention(q, k, v).transpose(1, 2).reshape(b, s, c))


class Block(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.ModuleDict({"c_fc": QLinear(width, 4 * width),
                                  "c_proj": QLinear(4 * width, width)})

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp["c_proj"](F.gelu(self.mlp["c_fc"](self.ln_2(x))))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(Block(width, heads) for _ in range(layers))


class VisionTower(nn.Module):
    """(N, 3, S, S) -> the projected class-token embedding (N, output_dim)."""

    def __init__(self, width: int, layers: int, heads: int, patch: int, image: int,
                 output_dim: int):
        super().__init__()
        grid = image // patch
        self.conv1 = QConv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = Transformer(width, layers, heads)
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))

    def forward(self, x):
        h = self.conv1(x).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(h.shape[0], 1, -1)
        h = self.ln_pre(torch.cat([cls, h], dim=1) + self.positional_embedding)
        for block in self.transformer.resblocks:
            h = block(h)
        return self.ln_post(h)[:, 0] @ self.proj


class ClipImageEmbedder(nn.Module):
    """FrozenOpenCLIPImagePredictionEmbedder with one conditioning frame a
    row: (N, H, W, 3) -> crossattn (N, 1, output_dim). Keys
    open_clip.model.visual.*"""

    def __init__(self, clip_width: int = 1280, clip_layers: int = 32, clip_heads: int = 16,
                 clip_patch_size: int = 14, clip_image_size: int = 224,
                 clip_output_dim: int = 1024, **unused):
        super().__init__()
        self.size = clip_image_size
        tower = VisionTower(clip_width, clip_layers, clip_heads, clip_patch_size,
                            clip_image_size, clip_output_dim)
        self.open_clip = nn.Module()
        self.open_clip.model = nn.Module()
        self.open_clip.model.visual = tower

    def forward(self, frames):
        return self.open_clip.model.visual(preprocess(frames, self.size))[:, None, :]

"""FID InceptionV3 feature extractor (port of gcd_tpu/models/inception.py).

pytorch-fid's InceptionV3 (torchvision's Inception3 with the FID blocks):
BasicConv2d = conv (no bias) + BatchNorm (eps 1e-3, running statistics) +
relu; the in-block average pools exclude the padding; Mixed_7c's pool
branch is a 3x3 max pool. The module's parameter names are pytorch-fid's
(`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch1x1.bn.running_var`, ...,
and the unused 1008-way `fc`), so a pt_inception-2015-12-05 state dict
loads with strict=True.

forward(x): images (N, 3, H, W); resized to 299 x 299 with JAX's
jax.image.resize "bilinear" (which low-passes an axis that shrinks, where
pytorch-fid's F.interpolate does not: utils/resize.py), [0, 1] -> [-1, 1]
with `normalize_input`; the outputs of `output_blocks` (0: 64 channels
after the stem, 1: 192, 2: 768, 3: the 2048 pooled), NCHW, one output
squeezed as the reference squeezes it ((N, 2048) for block 3). fp32, TF32
off.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from gcd_tpu_torch.models.lpips import fp32_convolutions
from gcd_tpu_torch.utils.resize import resize

Pad = Union[int, Tuple[int, int]]


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: Pad, stride: int = 1, padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Running statistics in either mode, as JAX's use_running_average.
        bn = self.bn
        return F.relu(F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight,
                                   bn.bias, training=False, eps=bn.eps))


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for conv in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                     self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """`pool` "avg" (Mixed_7b) or "max" (Mixed_7c, the FID checkpoint's)."""

    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, stride=1, padding=1) if self.pool == "max" else _avg_pool(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    def __init__(self, output_blocks: Sequence[int] = (3,), resize_input: bool = True,
                 normalize_input: bool = False):
        super().__init__()
        self.output_blocks = tuple(output_blocks)
        if max(self.output_blocks) > 3:
            raise ValueError(f"output_blocks {self.output_blocks}: the last block is 3")
        self.resize_input, self.normalize_input = resize_input, normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, 1008)  # the checkpoint's classifier; features stop before it

    def blocks(self) -> List[List[nn.Module]]:
        return [[self.Conv2d_1a_3x3, self.Conv2d_2a_3x3, self.Conv2d_2b_3x3],
                [self.Conv2d_3b_1x1, self.Conv2d_4a_3x3],
                [self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                 self.Mixed_6c, self.Mixed_6d, self.Mixed_6e],
                [self.Mixed_7a, self.Mixed_7b, self.Mixed_7c]]

    def forward(self, x: torch.Tensor):
        x = x.float()
        if self.resize_input:
            x = resize(x.permute(0, 2, 3, 1), (299, 299), "linear").permute(0, 3, 1, 2)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        outs = []
        with fp32_convolutions():
            for i, block in enumerate(self.blocks()[:max(self.output_blocks) + 1]):
                for module in block:
                    x = module(x)
                if i < 2:
                    x = F.max_pool2d(x, 3, stride=2)
                elif i == 3:
                    x = x.mean(dim=(2, 3), keepdim=True)
                if i in self.output_blocks:
                    outs.append(x)
        return outs[0].squeeze() if len(outs) == 1 else outs

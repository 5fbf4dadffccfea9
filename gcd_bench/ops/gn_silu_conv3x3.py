"""gcd::gn_silu_conv3x3(x, gn_weight, gn_bias, conv_weight, conv_bias, groups,
eps, silu, stats): GroupNorm (+ SiLU) of x (N, C, H, W), then a 3x3 conv,
padding 1, with conv_weight (F, C, 3, 3); the output (N, F, H, W)."""

from gcd_bench.ops import itemsize, tensor_bytes


def count(shapes, dtypes, scalars, frames):
    n, c, h, w = shapes[0]
    f = shapes[3][0]
    flops = 2 * n * h * w * f * c * 9
    reads = sum(tensor_bytes(shapes, dtypes, i) for i in range(5))
    return flops, reads + n * f * h * w * itemsize(dtypes, 0)

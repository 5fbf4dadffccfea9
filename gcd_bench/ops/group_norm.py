"""gcd::group_norm(x, weight, bias, groups, eps, silu, stats): GroupNorm
(+ SiLU) of x, the output shaped and typed as x."""

from gcd_bench.ops import numel, tensor_bytes


def count(shapes, dtypes, scalars, frames):
    n = numel(shapes[0])
    nbytes = 2 * tensor_bytes(shapes, dtypes, 0) + tensor_bytes(shapes, dtypes, 1) \
        + tensor_bytes(shapes, dtypes, 2)
    return 8 * n, nbytes

"""gcd::group_norm_from_sums(x, weight, bias, groups, eps, silu, s1, s2,
count): GroupNorm (+ SiLU) of x from given group sums."""

from gcd_bench.ops import numel, tensor_bytes


def count(shapes, dtypes, scalars, frames):
    n = numel(shapes[0])
    nbytes = 2 * tensor_bytes(shapes, dtypes, 0) + sum(
        tensor_bytes(shapes, dtypes, i, 4) for i in (1, 2, 6, 7))
    return 6 * n, nbytes

"""gcd::group_stats(x, groups) -> (2, N, groups) float32: the sums of x and
of x^2 of each group."""

from gcd_bench.ops import numel, tensor_bytes


def count(shapes, dtypes, scalars, frames):
    n = numel(shapes[0])
    groups = int(scalars[1]) if scalars and len(scalars) > 1 and scalars[1] not in ("", None) \
        else 32
    return 2 * n, tensor_bytes(shapes, dtypes, 0) + 2 * shapes[0][0] * groups * 4

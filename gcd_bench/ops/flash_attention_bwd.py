"""gcd::flash_attention_bwd(q, k, v, do, heads, scale) -> (dq, dk, dv): the
four products of the attention's backward (dv = p^T do, dp = do v^T,
dq = ds k, dk = ds^T q); the recompute of p is not counted."""

from gcd_bench.ops import tensor_bytes


def count(shapes, dtypes, scalars, frames):
    b, s, c = shapes[0]
    sk = shapes[1][1]
    flops = 8 * b * s * sk * c
    reads = sum(tensor_bytes(shapes, dtypes, i) for i in range(4))
    writes = sum(tensor_bytes(shapes, dtypes, i) for i in range(3))
    return flops, reads + writes

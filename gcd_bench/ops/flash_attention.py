"""gcd::flash_attention(q, k, v, heads, scale): softmax(q k^T) v over the
tokens of each row, q (B, S, C), k and v (B, Sk, C), heads of C / heads."""

from gcd_bench.ops import tensor_bytes


def count(shapes, dtypes, scalars, frames):
    b, s, c = shapes[0]
    sk = shapes[1][1]
    flops = 4 * b * s * sk * c  # q k^T and p v
    nbytes = sum(tensor_bytes(shapes, dtypes, i) for i in range(3))
    return flops, nbytes + tensor_bytes(shapes, dtypes, 0)

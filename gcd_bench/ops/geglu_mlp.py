"""gcd::geglu_mlp(x, w1, b1, w2, b2): x (..., C) -> [value | gate] (2I) ->
value * gelu(gate) -> (..., C_out); w1 (2I, C), w2 (C_out, I)."""

from gcd_bench.ops import itemsize, numel, tensor_bytes


def count(shapes, dtypes, scalars, frames):
    c = shapes[0][-1]
    m = numel(shapes[0]) // c
    two_i = shapes[1][0]
    c_out, inner = shapes[3]
    flops = 2 * m * c * two_i + 2 * m * inner * c_out
    reads = sum(tensor_bytes(shapes, dtypes, i) for i in range(5))
    return flops, reads + m * c_out * itemsize(dtypes, 0)

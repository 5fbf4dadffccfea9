"""gcd::temporal_attention(q, k, v, timesteps, heads, scale): attention over
the T frames at each token position, q, k, v and the output (B*T, S, C)."""

from gcd_bench.ops import tensor_bytes


def count(shapes, dtypes, scalars, frames):
    bt, s, c = shapes[0]
    t = int(scalars[3]) if scalars and len(scalars) > 3 and scalars[3] not in ("", None) \
        else int(frames)
    flops = 4 * bt * s * t * c
    return flops, 4 * tensor_bytes(shapes, dtypes, 0)

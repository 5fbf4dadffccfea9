"""K4's channels-last variants (csrc/fused_norm.cu) on the CPU: the rule that
picks one (ops/fused_norm.py::uses_split_path) and its constants pinned to
the source, and a model of variant (a)'s cluster partition and summation
order held against the JAX package's K4 (`_fused_forward`, the Pallas
`_kernel`, in TPU interpret mode).

Variant (a) sums as K5 does inside one block (tests/test_torch_gn_stats.py's
model with one chunk of ceil(P / 8) pixels a block) over the 8 blocks of a
sample's cluster, then adds the 8 block sums in rank order; it normalises
with scale = rsqrt(var + eps) gamma and shift = beta - mean scale. fp32
throughout; the result differs from JAX's only in the order of the sums and
in x scale + shift against (x - mean) scale + beta, ~1e-7 relative, against
tests/test_torch_fused_norm.py's bound of 1e-5.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcd_tpu.ops import fused_norm as jfn
from gcd_tpu_torch.ops.fused_norm import (
    ONEPASS_BYTES,
    ONEPASS_CLUSTER,
    ONEPASS_MIN_SAMPLES,
    ONEPASS_THREADS,
    ClStatsPlan,
    cl_one_pass,
    uses_split_path,
)
from tests.test_torch_gn_stats import cl_stats_model
from tests.torch_port_helpers import rel_l2
from tests.torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(__file__).resolve().parent.parent / "gcd_tpu_torch" / "csrc" / "fused_norm.cu"
CONSTS = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", CSRC.read_text())}
TOL = 1e-5
G = 32


def onepass_plan(c: int, p: int) -> ClStatsPlan:
    """Variant (a)'s partition (csrc/fused_norm.cu's op_plan) in the terms of
    K5's plan: one chunk of ceil(P / ONEPASS_CLUSTER) pixels a block, one
    cluster of ONEPASS_CLUSTER blocks a sample."""
    vpr = c // 8
    lanes = max(ONEPASS_THREADS // vpr, 1)
    span = -(-p // ONEPASS_CLUSTER)
    return ClStatsPlan(vpr, lanes, vpr * lanes, span, 1, ONEPASS_CLUSTER, 1, ONEPASS_CLUSTER)


def onepass_model(x: torch.Tensor, gamma, beta, eps: float, silu: bool) -> torch.Tensor:
    """Variant (a) on a channels-last (N, P, C) fp32 tensor."""
    n, p, c = x.shape
    s1, s2 = cl_stats_model(x, G, onepass_plan(c, p))
    count = p * (c // G)
    mean = s1 / count
    inv = torch.rsqrt((s2 / count - mean * mean).clamp_min(0.0) + eps)
    scale = inv.repeat_interleave(c // G, 1) * gamma
    shift = beta - mean.repeat_interleave(c // G, 1) * scale
    y = x * scale[:, None] + shift[:, None]
    return y * torch.sigmoid(y) if silu else y


def test_onepass_constants_match_the_kernel():
    names = ("OP_CLUSTER", "OP_MIN_N", "OP_BYTES", "OP_THREADS")
    assert {k: CONSTS[k] for k in names} == dict(zip(names, (
        ONEPASS_CLUSTER, ONEPASS_MIN_SAMPLES, ONEPASS_BYTES, ONEPASS_THREADS)))


def _channels_last(shape) -> torch.Tensor:
    fmt = torch.channels_last if len(shape) == 4 else torch.channels_last_3d
    return torch.empty(shape, device="meta").contiguous(memory_format=fmt)


# The channels-last GroupNorm shapes of a clip (chip_smoke.py phase 4): the
# UNet's per-frame sites at N = 28 (and 56, a served batch of two clips) take
# the one pass; the time_stack views (N = 2) and the conditioner's and
# decoder's planes take K5 and the apply pass.
ONE_PASS = [(28, 320, 32, 48), (28, 640, 16, 24), (28, 1280, 4, 6), (28, 1280, 8, 12),
            (56, 320, 32, 48), (56, 1280, 4, 6)]
SPLIT = [(2, 320, 14, 32, 48), (2, 640, 14, 16, 24), (2, 1280, 14, 4, 6),
         (2, 1280, 14, 8, 12), (4, 320, 14, 32, 48), (1, 128, 14, 256, 384),
         (1, 512, 14, 32, 48), (14, 128, 256, 384), (14, 256, 64, 96), (14, 512, 32, 48),
         (28, 512, 32, 48), (14, 512, 128, 192)]


@pytest.mark.parametrize("shape,split", [(s, False) for s in ONE_PASS] + [(s, True) for s in SPLIT])
def test_split_rule_at_clip_sites(shape, split):
    x = _channels_last(shape)
    assert uses_split_path(x, G) is split
    p = math.prod(shape[2:])
    assert cl_one_pass(shape[0], shape[1], p) is (not split)
    if not split:  # a block's span fits its shared memory, and a sample one cluster
        assert -(-p // ONEPASS_CLUSTER) * shape[1] * 2 <= ONEPASS_BYTES


# (N, H, W, C): the UNet's ds1 sample (C / G = 10: 8-channel vectors straddle
# groups), the 4 x 6 plane at C = 1280, and a ragged plane of 35 pixels (the
# last of the 8 blocks holds none) at C / G = 4 (every vector in two groups).
@pytest.mark.parametrize("shape", [(2, 32, 48, 320), (2, 4, 6, 1280), (3, 5, 7, 128)])
@pytest.mark.parametrize("silu", [False, True])
def test_onepass_model_matches_tpu_group_norm_kernel(shape, silu):
    rng = np.random.default_rng(5)
    c, eps = shape[-1], 1e-6
    x = (0.5 + 2.0 * rng.normal(size=shape)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    beta = (0.1 * rng.normal(size=c)).astype(np.float32)
    got = onepass_model(torch.from_numpy(x.reshape(shape[0], -1, c)), torch.from_numpy(gamma),
                        torch.from_numpy(beta), eps, silu)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfn._fused_forward(jnp.asarray(x), jnp.asarray(gamma),
                                             jnp.asarray(beta), G, eps, silu))
    assert rel_l2(got.numpy().reshape(shape), want) <= TOL

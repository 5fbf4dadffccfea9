"""K4 / K5 (ops/fused_norm.py) on the CPU: the plain versions against the
JAX package's GroupNorm kernels and their XLA reference, and the wrappers'
CPU routing.

The JAX side runs `_fused_forward` (K4's Pallas kernel) in TPU interpret
mode, `group_stats_pallas` (K5) with its `_INTERPRET` switch, and
`_reference_groupnorm`. Inputs are made channels-last for JAX and carried to
the port's channels-first layouts: (N, C, H, W), and the (B, C, T, H, W)
view of a (B, T, C, H, W) buffer that the time_stack blocks normalise. fp32
throughout; the sums differ only in order, ~1e-7 relative, against a bound
of 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcd_tpu.ops import fused_norm as jfn
from gcd_tpu_torch.ops import (
    KERNELS,
    group_norm,
    group_norm_plain,
    group_stats,
    group_stats_plain,
    kernel_enabled,
    kernel_flags,
)
from gcd_tpu_torch.ops.fused_norm import uses_split_path
from tests.torch_port_helpers import rel_l2

TOL = 1e-5
G = 32

# Channels-last JAX shapes: 2D (N, H, W, C) and time_stack (B, T, H, W, C).
SHAPES = [(3, 4, 6, 64), (2, 8, 12, 96), (2, 3, 4, 6, 64)]


@pytest.fixture
def interpret_stats():
    jfn._INTERPRET = True
    yield
    jfn._INTERPRET = False


def _inputs(shape, seed, const_group=False):
    rng = np.random.default_rng(seed)
    x = (0.5 + 2.0 * rng.normal(size=shape)).astype(np.float32)
    c = shape[-1]
    if const_group:  # channels of group 0 in sample 0 all 3.0: variance 0
        x[0, ..., : c // G] = 3.0
    scale = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=c)).astype(np.float32)
    return x, scale, bias


def _port_layout(x):
    """channels-last numpy -> the port's channels-first tensor (a transposed
    view for the 5D case)."""
    if x.ndim == 4:
        return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3))).transpose(1, 2)


def _jax_layout(y):
    y = y.numpy()
    return y.transpose(0, 2, 3, 1) if y.ndim == 4 else y.transpose(0, 2, 3, 4, 1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm_plain_matches_reference_and_tpu_kernel(shape, silu, eps):
    x, scale, bias = _inputs(shape, 0)
    xt = _port_layout(x)
    out = _jax_layout(group_norm_plain(xt, torch.from_numpy(scale),
                                       torch.from_numpy(bias), G, eps, silu))
    ref = np.asarray(jfn._reference_groupnorm(jnp.asarray(x), jnp.asarray(scale),
                                              jnp.asarray(bias), G, eps, silu))
    with pltpu.force_tpu_interpret_mode():
        k4 = np.asarray(jfn._fused_forward(jnp.asarray(x), jnp.asarray(scale),
                                           jnp.asarray(bias), G, eps, silu))
    assert rel_l2(out, ref) <= TOL
    assert rel_l2(out, k4) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_group_stats_plain_matches_tpu_stats_kernel(shape, interpret_stats):
    x, _, _ = _inputs(shape, 1)
    n, c = shape[0], shape[-1]
    s1, s2 = group_stats_plain(_port_layout(x), G)
    j1, j2 = jfn.group_stats_pallas(jnp.asarray(x.reshape(n, -1, c)), G)
    assert s1.shape == s2.shape == (n, G) and s1.dtype == torch.float32
    assert rel_l2(s1.numpy(), np.asarray(j1)) <= TOL
    assert rel_l2(s2.numpy(), np.asarray(j2)) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_constant_group_clamps_to_beta(shape):
    """A group of equal values has variance 0: its output is exactly beta
    (no NaN), and the rest matches the reference."""
    x, scale, bias = _inputs(shape, 2, const_group=True)
    out = _jax_layout(group_norm_plain(_port_layout(x), torch.from_numpy(scale),
                                       torch.from_numpy(bias), G, 1e-6, False))
    ref = np.asarray(jfn._reference_groupnorm(jnp.asarray(x), jnp.asarray(scale),
                                              jnp.asarray(bias), G, 1e-6, False))
    cpg = shape[-1] // G
    assert np.isfinite(out).all()
    const = out[0, ..., :cpg]
    np.testing.assert_array_equal(const, np.broadcast_to(bias[:cpg], const.shape))
    assert rel_l2(out, ref) <= TOL


def test_plain_clamps_negative_variance():
    """Where fp32 rounding makes sum(x^2)/n - mean^2 negative beyond eps, the
    clamp keeps rsqrt finite (F2: the TPU kernel does not clamp)."""
    x = torch.full((1, 32, 8, 8), 333.3)
    y = group_norm_plain(x, torch.ones(32), torch.zeros(32), G, 1e-6, False)
    xf = x.reshape(1, G, 1, 64)
    mean = xf.sum(dim=(2, 3)) / 64
    var = (xf * xf).sum(dim=(2, 3)) / 64 - mean * mean
    assert float(var.min()) < -1e-6  # the case the clamp exists for
    assert torch.isfinite(y).all()


def test_wrappers_take_plain_path_on_cpu_without_counting():
    x, scale, bias = _inputs(SHAPES[2], 3)
    xt, w, b = _port_layout(x), torch.from_numpy(scale), torch.from_numpy(bias)
    before = {name: fn.launches for name, fn in KERNELS.items()}
    torch.testing.assert_close(group_norm(xt, w, b, G, 1e-5, True),
                               group_norm_plain(xt, w, b, G, 1e-5, True), rtol=0, atol=0)
    for got, want in zip(group_stats(xt, G), group_stats_plain(xt, G)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert {name: fn.launches for name, fn in KERNELS.items()} == before


def test_gn_flags_default_on_and_split_rule():
    assert kernel_enabled("fused_gn") and kernel_enabled("gn_stats")
    with kernel_flags(fused_gn=False, gn_stats=False):
        assert not kernel_enabled("fused_gn") and not kernel_enabled("gn_stats")
    # UNet ds1 planes fit one block; the time_stack video and VAE planes split.
    assert not uses_split_path(torch.empty(28, 960, 32, 48, device="meta"), G)
    assert uses_split_path(torch.empty(2, 320, 14, 32, 48, device="meta"), G)
    assert uses_split_path(torch.empty(14, 128, 256, 384, device="meta"), G)

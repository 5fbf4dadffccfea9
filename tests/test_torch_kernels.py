"""The port's kernel modules on the CPU: each plain PyTorch version against
the JAX package's XLA reference of the same kernel, and the wrapper's CPU
routing.

fp32 throughout, JAX at jax_default_matmul_precision=highest (conftest).
Both sides compute the same sums in fp32 in a different order, so they agree
to ~1e-7 relative; the 1e-5 bound leaves two orders of margin and still
catches any error in layout, masking, scaling or GELU variant (tanh vs erf
GELU alone differs by ~1e-4 here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.ops.flash_attention import _xla_mh
from gcd_tpu.ops.fused_mlp import _xla_geglu_mlp
from gcd_tpu.ops.temporal_attention import _xla_temporal
from gcd_tpu_torch.ops import (
    KERNELS,
    flash_attention,
    flash_attention_plain,
    geglu_mlp,
    geglu_mlp_plain,
    kernel_enabled,
    kernel_flags,
    temporal_attention,
    temporal_attention_plain,
)
from tests.torch_port_helpers import rel_l2

TOL = 1e-5


def _qkv(rng, *shape):
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,s,heads,d", [(2, 40, 2, 64), (3, 24, 4, 16), (1, 17, 1, 128)])
def test_flash_plain_matches_xla_mh(b, s, heads, d):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, b, s, heads * d)
    scale = d ** -0.5
    ref = _xla_mh(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, heads)
    out = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), heads, scale)
    assert out.shape == (b, s, heads * d)
    assert rel_l2(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("b,t,s,heads,d", [(2, 14, 8, 5, 64), (1, 3, 20, 2, 16)])
def test_temporal_plain_matches_xla_temporal(b, t, s, heads, d):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, b * t, s, heads * d)
    scale = d ** -0.5
    ref = _xla_temporal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), t, heads, scale)
    out = temporal_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), t, heads, scale)
    assert out.shape == (b * t, s, heads * d)
    assert rel_l2(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("m,c,inner,c_out", [(96, 64, 256, 64), (30, 32, 128, 48)])
def test_geglu_plain_matches_xla_exact_gelu(m, c, inner, c_out):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(m, c)).astype(np.float32)
    # flax layout: w1 (C, 2I) [value | gate], w2 (I, C_out)
    w1 = rng.normal(0, c ** -0.5, (c, 2 * inner)).astype(np.float32)
    b1 = rng.normal(0, 0.5, (2 * inner,)).astype(np.float32)
    w2 = rng.normal(0, inner ** -0.5, (inner, c_out)).astype(np.float32)
    b2 = rng.normal(0, 0.5, (c_out,)).astype(np.float32)
    ref = _xla_geglu_mlp(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                         jnp.asarray(w2), jnp.asarray(b2), exact_gelu=True)
    tanh_ref = _xla_geglu_mlp(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                              jnp.asarray(w2), jnp.asarray(b2), exact_gelu=False)
    # torch Linear layout: w1 (2I, C), w2 (C_out, I)
    out = geglu_mlp_plain(torch.from_numpy(x), torch.from_numpy(w1.T.copy()),
                          torch.from_numpy(b1), torch.from_numpy(w2.T.copy()),
                          torch.from_numpy(b2))
    assert rel_l2(out.numpy(), ref) <= TOL
    assert rel_l2(out.numpy(), tanh_ref) > 10 * TOL  # the bound tells the variants apart


def test_wrappers_take_plain_path_on_cpu_without_counting():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 6, 64))
    w1, b1 = torch.randn(256, 64), torch.randn(256)
    w2, b2 = torch.randn(64, 128), torch.randn(64)
    before = {name: fn.launches for name, fn in KERNELS.items()}
    torch.testing.assert_close(flash_attention(q, k, v, 1), flash_attention_plain(q, k, v, 1),
                               rtol=0, atol=0)
    torch.testing.assert_close(temporal_attention(q, k, v, 2, 2),
                               temporal_attention_plain(q, k, v, 2, 2), rtol=0, atol=0)
    torch.testing.assert_close(geglu_mlp(q, w1, b1, w2, b2),
                               geglu_mlp_plain(q, w1, b1, w2, b2), rtol=0, atol=0)
    assert {name: fn.launches for name, fn in KERNELS.items()} == before


def test_kernel_flags_nest_and_reject_unknown():
    assert kernel_enabled("flash")
    with kernel_flags(flash=False):
        assert not kernel_enabled("flash") and kernel_enabled("tattn")
        with kernel_flags(flash=True):
            assert kernel_enabled("flash")
        assert not kernel_enabled("flash")
    assert kernel_enabled("flash")
    with pytest.raises(ValueError):
        with kernel_flags(flash_pack2=True):
            pass

"""Each port module that holds a kernel against its JAX counterpart, weights
carried across by the weight bridge (gcd_tpu_torch.io.convert).

fp32 on the CPU (the wrappers take their plain versions there), JAX at
highest matmul precision. The modules chain a few matmuls, LayerNorms and
softmaxes whose fp32 sums differ only in order (~1e-6 relative); the 1e-4
bound catches any wrong key, layout, residual or normalisation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.models.attention import CrossAttention as JCrossAttention
from gcd_tpu.models.attention import SpatialTransformer as JSpatialTransformer
from gcd_tpu.models.attention import TemporalSelfAttention as JTemporalSelfAttention
from gcd_tpu.models.layers import FeedForward as JFeedForward
from gcd_tpu.models.video_attention import SpatialVideoTransformer as JSpatialVideoTransformer
from gcd_tpu_torch.models.attention import (
    CrossAttention,
    SpatialTransformer,
    TemporalSelfAttention,
)
from gcd_tpu_torch.models.layers import FeedForward
from gcd_tpu_torch.models.video_attention import SpatialVideoTransformer
from tests.torch_port_helpers import flax_params, load_port, nchw, nhwc, rel_l2
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4


def _apply(jmod, params, *args, **kwargs):
    return np.asarray(jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, **kwargs))(
        params, *args))


def test_feed_forward():
    x = np.random.default_rng(0).normal(size=(2, 12, 32)).astype(np.float32)
    jmod = JFeedForward(glu=True)
    params = flax_params(jmod, 1, jnp.asarray(x))
    ref = _apply(jmod, params, jnp.asarray(x))
    with torch.no_grad():
        out = load_port(FeedForward(32), params)(torch.from_numpy(x)).numpy()
    assert rel_l2(out, ref) <= TOL


@pytest.mark.parametrize("ctx_len", [None, 1, 5])
def test_cross_attention(ctx_len):
    """Self-attention (K1's site), the exact one-token shortcut, and a
    multi-token context."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, 32)).astype(np.float32)
    args = [jnp.asarray(x)]
    ctx_t = None
    if ctx_len is not None:
        ctx = rng.normal(size=(2, ctx_len, 24)).astype(np.float32)
        args.append(jnp.asarray(ctx))
        ctx_t = torch.from_numpy(ctx)
    jmod = JCrossAttention(heads=2, dim_head=16,
                           context_dim=24 if ctx_len else None)
    params = flax_params(jmod, 3, *args)
    ref = _apply(jmod, params, *args)
    port = load_port(CrossAttention(32, 2, 16, 24 if ctx_len else None), params)
    with torch.no_grad():
        out = port(torch.from_numpy(x), ctx_t).numpy()
    assert out.shape == ref.shape
    assert rel_l2(out, ref) <= TOL


def test_temporal_self_attention():
    x = np.random.default_rng(4).normal(size=(2 * 3, 10, 32)).astype(np.float32)
    jmod = JTemporalSelfAttention(heads=2, dim_head=16)
    params = flax_params(jmod, 5, jnp.asarray(x), 3)
    ref = _apply(jmod, params, jnp.asarray(x), timesteps=3)
    with torch.no_grad():
        out = load_port(TemporalSelfAttention(32, 2, 16), params)(
            torch.from_numpy(x), 3).numpy()
    assert rel_l2(out, ref) <= TOL


def test_spatial_transformer():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 4, 4, 32)).astype(np.float32)
    ctx = rng.normal(size=(2, 1, 24)).astype(np.float32)
    jmod = JSpatialTransformer(n_heads=2, d_head=16, context_dim=24, use_linear=True)
    params = flax_params(jmod, 7, jnp.asarray(x), jnp.asarray(ctx))
    ref = _apply(jmod, params, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        out = load_port(SpatialTransformer(32, 2, 16, 1, 24), params)(
            nchw(x), torch.from_numpy(ctx))
    assert rel_l2(nhwc(out), ref) <= TOL


def test_spatial_video_transformer():
    b, t = 2, 3
    rng = np.random.default_rng(8)
    x = rng.normal(size=(b * t, 4, 4, 32)).astype(np.float32)
    ctx = rng.normal(size=(b * t, 1, 24)).astype(np.float32)
    ioi = np.zeros((b, t), np.float32)
    ioi[1, 2] = 1.0  # one image-only frame exercises the per-frame alpha
    jmod = JSpatialVideoTransformer(
        n_heads=2, d_head=16, context_dim=24, use_spatial_context=True,
        use_linear=True, ff_in=True, merge_strategy="learned_with_images")
    args = (jnp.asarray(x), jnp.asarray(ctx), None, t, jnp.asarray(ioi))
    params = flax_params(jmod, 9, *args)
    ref = np.asarray(jax.jit(
        lambda p, x, c, i: jmod.apply({"params": p}, x, c, None, t, i))(
            params, *args[:2], args[4]))
    port = load_port(SpatialVideoTransformer(
        32, 2, 16, 1, 24, ff_in=True, merge_strategy="learned_with_images",
        use_spatial_context=True, use_linear=True), params)
    with torch.no_grad():
        out = port(nchw(x), torch.from_numpy(ctx), t, torch.from_numpy(ioi))
    assert rel_l2(nhwc(out), ref) <= TOL

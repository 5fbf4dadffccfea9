"""The port's VideoUNet at each transformer option of the JAX package's
VideoUNet alone, on TINY_UNET, against the JAX network (weights carried by
the weight bridge, strict=True), and a per-video time_context; the
SpatialVideoTransformer without self-attention (a block option the JAX
VideoUNet does not pass on) against the JAX block. fp32 on the CPU at 1e-4,
as tests/test_torch_unet_options.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.models.video_attention import SpatialVideoTransformer as JSpatialVideoTransformer
from gcd_tpu_torch.models.unet import VideoUNet
from gcd_tpu_torch.models.video_attention import SpatialVideoTransformer
from tests.torch_port_helpers import TINY_UNET, flax_params, load_port, nchw, nhwc, rel_l2
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_unet_helpers import CTX_LEN, TOL, check_option, inputs, port_call


@pytest.mark.parametrize("option,value", [
    ("use_linear_in_transformer", False), ("use_spatial_context", False),
    ("disable_temporal_crossattention", True),
])
def test_option_matches_jax(option, value):
    check_option({option: value}, 3)


def test_time_context_matches_jax():
    """use_spatial_context False with a per-video (B, Ck) time_context: the
    temporal blocks' context layers sized by time_context_dim."""
    check_option({"use_spatial_context": False}, 4, time_context=True)


def test_time_context_without_its_width_raises():
    """Built without time_context_dim, the temporal blocks attend over the
    frames; a time_context given to them raises rather than go unread (the
    JAX blocks would attend to it)."""
    port = VideoUNet(**{**TINY_UNET, "use_spatial_context": False})
    with pytest.raises(ValueError, match="time_context_dim"), torch.no_grad():
        port_call(port, inputs(0), time_context=True)


@pytest.mark.parametrize("use_spatial_context", [True, False])
def test_block_without_self_attention_matches_jax(use_spatial_context):
    """disable_self_attn: the spatial attn1 attends to the context, and the
    temporal attn1 to frame 0's context (use_spatial_context) or over the
    frames (no per-video context)."""
    b, t = 1, 3
    rng = np.random.default_rng(11)
    x = rng.normal(size=(b * t, 4, 4, 32)).astype(np.float32)
    ctx = rng.normal(size=(b * t, CTX_LEN, 24)).astype(np.float32)
    ioi = np.zeros((b, t), np.float32)
    kw = dict(context_dim=24, use_spatial_context=use_spatial_context, use_linear=False,
              ff_in=True, disable_self_attn=True)
    jmod = JSpatialVideoTransformer(n_heads=2, d_head=16, **kw)
    args = (jnp.asarray(x), jnp.asarray(ctx), None, t, jnp.asarray(ioi))
    params = flax_params(jmod, 12, *args)
    ref = np.asarray(jmod.apply({"params": params}, *args))
    port = load_port(SpatialVideoTransformer(32, 2, 16, 1, **kw), params)
    assert port.transformer_blocks[0].attn1.to_k.in_features == 24
    with torch.no_grad():
        out = port(nchw(x), torch.from_numpy(ctx), t, torch.from_numpy(ioi))
    assert rel_l2(nhwc(out), ref) <= TOL

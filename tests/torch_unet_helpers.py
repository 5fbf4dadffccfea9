"""Shared helpers of the VideoUNet option tests (tests/test_torch_unet_*.py):
the JAX VideoUNet and the port's at TINY_UNET plus options, with seeded
weights carried by the weight bridge and loaded with strict=True.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gcd_tpu.models.unet import VideoUNet as JVideoUNet
from gcd_tpu_torch.models.unet import VideoUNet
from tests.torch_port_helpers import TINY_UNET, flax_params, load_port, nchw, nhwc, rel_l2

TOL = 1e-4
B, T, H, W = 1, 3, 8, 8
Y_DIM = TINY_UNET["adm_in_channels"] + TINY_UNET["aux_emb_dim"]
CTX_LEN = 5
# The four keys whose port defaults were not JAX's; every shipped config
# sets them.
DEFAULTED = ("merge_strategy", "video_kernel_size", "use_linear_in_transformer",
             "use_spatial_context")
# The card's option UNets (chip_smoke.py's conditioning phase (d)).
CONFIG_A = dict(use_scale_shift_norm=True, resblock_updown=True,
                use_linear_in_transformer=False, use_spatial_context=False,
                merge_strategy="fixed", video_kernel_size=3)
CONFIG_B = dict(disable_temporal_crossattention=True, conv_resample=False,
                extra_ff_mix_layer=True)


def inputs(seed, ctx_len=CTX_LEN):
    rng = np.random.default_rng(seed)
    ioi = np.zeros((B, T), np.float32)
    ioi[0, 1] = 1.0  # an image-only frame exercises learned_with_images
    return dict(x=rng.normal(size=(B * T, H, W, 8)).astype(np.float32),
                ts=rng.normal(size=(B * T,)).astype(np.float32) * 3.0,
                ctx=rng.normal(size=(B * T, ctx_len, 24)).astype(np.float32),
                y=rng.normal(size=(B * T, Y_DIM)).astype(np.float32), ioi=ioi,
                tctx=rng.normal(size=(B, 12)).astype(np.float32))


def unet_pair(options, seed, time_context=False):
    """(JAX module, its seeded params, the port's UNet with them loaded)."""
    kwargs = {**TINY_UNET, **options}
    port_kwargs = dict(kwargs)
    if time_context:
        port_kwargs["time_context_dim"] = 12
    jmod = JVideoUNet(**kwargs)
    a = inputs(seed)
    params = flax_params(jmod, seed, *jax_args(a), **jax_kwargs(a, time_context))
    return jmod, params, load_port(VideoUNet(**port_kwargs), params)


def jax_args(a):
    return tuple(jnp.asarray(a[k]) for k in ("x", "ts", "ctx", "y"))


def jax_kwargs(a, time_context):
    kw = dict(num_video_frames=T, image_only_indicator=jnp.asarray(a["ioi"]))
    if time_context:
        kw["time_context"] = jnp.asarray(a["tctx"])
    return kw


def jax_apply(jmod, params, a, kw):
    return np.asarray(jax.jit(lambda p, *args: jmod.apply({"params": p}, *args, **kw))(
        params, *jax_args(a)))


def port_call(port, a, time_context=False):
    kw = {"time_context": torch.from_numpy(a["tctx"])} if time_context else {}
    return port(nchw(a["x"]), torch.from_numpy(a["ts"]), torch.from_numpy(a["ctx"]),
                torch.from_numpy(a["y"]), num_video_frames=T,
                image_only_indicator=torch.from_numpy(a["ioi"]), **kw)


def check_option(options, seed, time_context=False):
    jmod, params, port = unet_pair(options, seed, time_context)
    a = inputs(seed + 100)
    kw = jax_kwargs(a, time_context)
    ref = jax_apply(jmod, params, a, kw)
    with torch.no_grad():
        out = port_call(port, a, time_context)
    assert np.abs(ref).max() > 1e-2
    assert rel_l2(nhwc(out), ref) <= TOL
    return port

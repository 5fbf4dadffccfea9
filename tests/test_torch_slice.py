"""The tiny VideoUNet, the tiny VideoDecoder, and the whole tiny slice
(DiffusionEngine.sample_video_from_cond: 3 CFG Euler-EDM steps + decode; and
DiffusionEngine.sample_video: conditioner, sampling and decode from raw
frames) of the port against the JAX package, same weights and same noise on
both sides.

fp32 on the CPU, JAX at highest matmul precision. The UNet and decoder chain
dozens of layers whose fp32 sums differ only in order: 1e-4 relative. The
slice multiplies the initial noise by sqrt(1 + 700^2) and takes 3 Euler steps
from there, so the fp32 differences of the UNet's outputs are amplified
before the decoder: 1e-3 relative on the [0, 1] frames.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.models.unet import VideoUNet as JVideoUNet
from gcd_tpu.models.vae import VideoDecoder as JVideoDecoder
from gcd_tpu.utils.config import instantiate_from_config as j_instantiate
from gcd_tpu_torch.engine.build import load_engine
from gcd_tpu_torch.models.unet import VideoUNet
from gcd_tpu_torch.models.vae import VideoDecoder
from gcd_tpu_torch.utils.config import instantiate_from_config, load_config
from tests.torch_port_helpers import (
    TINY_CONFIG,
    TINY_DD,
    TINY_UNET,
    engine_params,
    engine_state_dict,
    flax_params,
    load_port,
    nchw,
    nhwc,
    rel_l2,
    tiny_batch,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, H, W = 3, 16, 16
Y_DIM = TINY_UNET["adm_in_channels"] + TINY_UNET["aux_emb_dim"]


def _unet_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, H, W, 8)).astype(np.float32),
            rng.normal(size=(T,)).astype(np.float32),
            rng.normal(size=(T, 1, 24)).astype(np.float32),
            rng.normal(size=(T, Y_DIM)).astype(np.float32))


def test_tiny_unet_matches_jax():
    x, ts, ctx, y = _unet_inputs(0)
    ioi = np.zeros((1, T), np.float32)
    jmod = JVideoUNet(**TINY_UNET)
    params = flax_params(jmod, 1, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                         jnp.asarray(y), num_video_frames=T,
                         image_only_indicator=jnp.asarray(ioi))
    ref = np.asarray(jax.jit(lambda p, *a: jmod.apply(
        {"params": p}, *a, num_video_frames=T,
        image_only_indicator=jnp.asarray(ioi)))(
            params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jnp.asarray(y)))
    port = load_port(VideoUNet(**TINY_UNET), params)
    with torch.no_grad():
        out = port(nchw(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                   torch.from_numpy(y), num_video_frames=T,
                   image_only_indicator=torch.from_numpy(ioi))
    assert np.abs(ref).max() > 1e-2
    assert rel_l2(nhwc(out), ref) <= 1e-4


def test_tiny_video_decoder_matches_jax():
    z = np.random.default_rng(2).normal(size=(4, 16, 16, 4)).astype(np.float32)
    jmod = JVideoDecoder(**TINY_DD, video_kernel_size=[3, 1, 1])
    params = flax_params(jmod, 3, jnp.asarray(z), timesteps=2)
    ref = np.asarray(jax.jit(lambda p, z: jmod.apply({"params": p}, z, timesteps=2))(
        params, jnp.asarray(z)))
    port = load_port(VideoDecoder(**TINY_DD, video_kernel_size=[3, 1, 1]), params)
    with torch.no_grad():
        out = port(nchw(z), 2)
    assert out.shape == (4, 3, 32, 32)
    assert rel_l2(nhwc(out), ref) <= 1e-4


def _tiny_engine_config():
    """configs/infer_kubric.yaml with the model cut to TINY_UNET / TINY_DD,
    3 frames and 3 sampling steps."""
    cfg = copy.deepcopy(load_config(os.path.join(REPO, "configs", "infer_kubric.yaml"))["model"])
    p = cfg["params"]
    p["network_config"]["params"].update(TINY_UNET)
    p["first_stage_config"]["params"]["decoder_config"]["params"].update(TINY_DD)
    p["sampler_config"]["params"]["num_steps"] = 3
    p["sampler_config"]["params"]["guider_config"]["params"]["num_frames"] = T
    return cfg


@pytest.mark.parametrize("decoding_t", [T, None])
def test_tiny_slice_matches_jax(decoding_t):
    """decoding_t=None decodes in the config's chunks of 2 frames (2 + 1)."""
    cfg = _tiny_engine_config()
    rng = np.random.default_rng(4)
    c = {"crossattn": rng.normal(size=(T, 1, 24)), "vector": rng.normal(size=(T, Y_DIM)),
         "concat": rng.normal(size=(T, H, W, 4))}
    c = {k: v.astype(np.float32) for k, v in c.items()}
    uc = {"crossattn": np.zeros_like(c["crossattn"]), "vector": c["vector"],
          "concat": np.zeros_like(c["concat"])}
    noise = rng.normal(size=(T, H, W, 4)).astype(np.float32)

    # JAX: the body of gcd_tpu DiffusionEngine.sample_video after the
    # conditioner (engine.py:405-431), on the same config.
    jcfg = copy.deepcopy(cfg)
    jcfg["params"].pop("conditioner_config")
    jeng = j_instantiate(jcfg)
    x0 = jnp.zeros((T, H, W, 8))
    mparams = flax_params(jeng.network, 5, x0, jnp.zeros((T,)), jnp.zeros((T, 1, 24)),
                          jnp.zeros((T, Y_DIM)), num_video_frames=T,
                          image_only_indicator=jnp.zeros((1, T)))
    dparams = flax_params(jeng.first_stage_model.decoder, 6, jnp.zeros((T, H, W, 4)),
                          timesteps=T)
    ioi2 = jnp.zeros((2, T))

    def j_sample(mp, dp, noise, c, uc):
        def denoiser_fn(x, sigma, cond):
            return jeng.denoiser(
                lambda xx, cn, cc, **kw: jeng.network_fn(
                    mp, xx, cn, cc, num_video_frames=T,
                    image_only_indicator=ioi2[:x.shape[0] // T]),
                x, sigma, cond)

        z = jeng.sampler(denoiser_fn, noise, cond=c, uc=uc)
        x = jeng.decode_first_stage({"first_stage": {"decoder": dp}}, z, decoding_t=decoding_t)
        return jnp.clip((x + 1.0) / 2.0, 0.0, 1.0)

    ref = np.asarray(jax.jit(j_sample)(mparams, dparams, jnp.asarray(noise),
                                       jax.tree_util.tree_map(jnp.asarray, c),
                                       jax.tree_util.tree_map(jnp.asarray, uc)))

    engine = instantiate_from_config(cfg).eval()
    load_port(engine.model.diffusion_model, mparams)
    load_port(engine.first_stage_model.decoder, dparams)
    to_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    out = engine.sample_video_from_cond(to_t(c), to_t(uc), torch.from_numpy(noise),
                                        decoding_t=decoding_t)
    assert out.shape == (T, 2 * H, 2 * W, 3) == ref.shape
    assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0
    assert ref.std() > 1e-2
    assert rel_l2(out.numpy(), ref) <= 1e-3


def test_tiny_sample_video_matches_jax():
    """configs/smoke_kubric_tiny.yaml whole (CLIP width 32, VAE ch 32): 3
    frames of 32x48, 3 steps, decode in the config's chunks of 2. The port
    gets JAX's latent noise, normal(split(key)[0]), through `noise`."""
    cfg = load_config(TINY_CONFIG)["model"]
    batch = tiny_batch(T, 32, 48, 8)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jeng = j_instantiate(copy.deepcopy(cfg))
    params = engine_params(jeng, batch, 20)
    key = jax.random.PRNGKey(3)
    ref = jax.jit(lambda p, b, k: jeng.sample_video(p, b, k, num_steps=3,
                                                    return_latents=True))(params, jbatch, key)
    noise = jax.random.normal(jax.random.split(key)[0], (T, 4, 6, 4), dtype=jnp.float32)

    emb_models = cfg["params"]["conditioner_config"]["params"]["emb_models"]
    engine = load_engine(TINY_CONFIG, device="cpu", dtype=torch.float32,
                         state_dict=engine_state_dict(params, emb_models, 30))
    out = engine.sample_video({k: torch.from_numpy(v) for k, v in batch.items()},
                              noise=torch.from_numpy(np.array(noise)), num_steps=3,
                              return_latents=True)
    assert sorted(out) == sorted(ref) == ["cond_video", "sampled_video", "sampled_z"]
    assert out["sampled_video"].shape == (T, 32, 48, 3) == ref["sampled_video"].shape
    assert np.asarray(ref["sampled_video"]).std() > 1e-2
    assert rel_l2(out["cond_video"].numpy(), ref["cond_video"]) <= 1e-6
    assert rel_l2(out["sampled_z"].numpy(), ref["sampled_z"]) <= 1e-3
    assert rel_l2(out["sampled_video"].numpy(), ref["sampled_video"]) <= 1e-3

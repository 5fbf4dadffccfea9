"""The port's conditioner modules against the JAX package: the CLIP tower
and its preprocessing, the VAE Encoder and 2D Decoder, each embedder, and the
GeneralConditioner's (c, uc), weights carried by the weight bridge and
loaded with strict=True.

fp32 on the CPU, JAX at highest matmul precision. Each module chains convs,
matmuls, LayerNorms / GroupNorms and softmaxes whose fp32 sums differ only in
order (~1e-6 relative); the 1e-4 bound catches any wrong key, layout,
rounding point or routing.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.models import clip as jclip
from gcd_tpu.models import embedders as jemb
from gcd_tpu.models import vae as jvae
from gcd_tpu_torch.io.convert import state_dict_from_flax
from gcd_tpu_torch.models import clip, embedders, vae
from gcd_tpu_torch.utils.config import load_config
from tests.torch_port_helpers import (
    TINY_CONFIG,
    TINY_DD,
    conditioner_extras,
    flax_params,
    kl_decoder_state_dict,
    load_port,
    nchw,
    nhwc,
    rel_l2,
    tiny_batch,
)

TOL = 1e-4
T, H, W = 3, 32, 48
# configs/smoke_kubric_tiny.yaml's tower.
TINY_CLIP = dict(width=32, layers=2, heads=2, patch_size=8, image_size=32, output_dim=24)
UC_KEYS = ["cond_frames", "cond_frames_without_noise"]


def _apply(jmod, params, *args, **kwargs):
    return jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, **kwargs))(params, *args)


def _emb_models():
    return copy.deepcopy(load_config(TINY_CONFIG)["model"]["params"]["conditioner_config"]
                         ["params"]["emb_models"])


def _batch(seed=0):
    return tiny_batch(T, H, W, seed)


def _tower_state_dict(params):
    """A bare tower's keys: drop the open_clip.model.visual. prefix that
    gcd_clip_rename gives inside the conditioner."""
    sd = state_dict_from_flax({"open_clip": {"visual": params}})
    return {k.removeprefix("open_clip.model.visual."): v for k, v in sd.items()}


def test_clip_tower():
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jmod = jclip.CLIPVisionTower(**TINY_CLIP)
    params = flax_params(jmod, 1, jnp.asarray(x))
    ref = np.asarray(_apply(jmod, params, jnp.asarray(x)))
    port = clip.CLIPVisionTower(**TINY_CLIP)
    port.load_state_dict(_tower_state_dict(params), strict=True)
    with torch.no_grad():
        out = port.eval()(nchw(x)).numpy()
    assert out.shape == (2, 24)
    assert rel_l2(out, ref) <= TOL


@pytest.mark.parametrize("image_size", [32, 224])
def test_clip_preprocess(image_size):
    """32x48 frames: downscaled with the gaussian pre-blur (32) and upscaled
    (224, the real tower's size)."""
    x = np.random.default_rng(2).uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    ref = np.asarray(jclip.clip_preprocess(jnp.asarray(x), image_size))
    out = nhwc(clip.clip_preprocess(nchw(x), image_size))
    assert out.shape == (2, image_size, image_size, 3)
    assert rel_l2(out, ref) <= 1e-5


def test_vae_encoder():
    """TINY_DD's attn_resolutions [16] puts an AttnBlock in the encoder."""
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jmod = jvae.Encoder(**TINY_DD)
    params = flax_params(jmod, 4, jnp.asarray(x))
    ref = np.asarray(_apply(jmod, params, jnp.asarray(x)))
    with torch.no_grad():
        out = load_port(vae.Encoder(**TINY_DD), params)(nchw(x))
    assert out.shape == (2, 8, 16, 16)
    assert rel_l2(nhwc(out), ref) <= TOL


def test_vae_decoder_2d():
    z = np.random.default_rng(5).normal(size=(2, 16, 16, 4)).astype(np.float32)
    jmod = jvae.Decoder(**TINY_DD)
    params = flax_params(jmod, 6, jnp.asarray(z))
    ref = np.asarray(_apply(jmod, params, jnp.asarray(z)))
    with torch.no_grad():
        out = load_port(vae.Decoder(**TINY_DD), params)(nchw(z))
    assert out.shape == (2, 3, 32, 32)
    assert rel_l2(nhwc(out), ref) <= TOL


@pytest.mark.parametrize("index", [1, 4])
def test_concat_timestep_embedder(index):
    cfg = _emb_models()[index]
    x = _batch()[cfg["input_key"]] * np.float32(1.7)  # not the same value everywhere
    x[0] = 3.0
    ref = np.asarray(jemb.ConcatTimestepEmbedderND(**cfg["params"]).apply({}, jnp.asarray(x)))
    out = embedders.ConcatTimestepEmbedderND(**cfg["params"])(torch.from_numpy(x)).numpy()
    assert out.shape == (T, cfg["params"]["outdim"])
    assert rel_l2(out, ref) <= TOL


@pytest.mark.parametrize("name,shape", [("SphericalEmbedder", (T, 3)),
                                        ("CameraEmbedder", (T, 3, 4))])
def test_camera_embedders(name, shape):
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    jmod = getattr(jemb, name)(embed_dim=8)
    params = flax_params(jmod, 8, jnp.asarray(x))
    ref = np.asarray(_apply(jmod, params, jnp.asarray(x)))
    with torch.no_grad():
        out = load_port(getattr(embedders, name)(embed_dim=8), params)(torch.from_numpy(x))
    assert rel_l2(out.numpy(), ref) <= TOL


def test_clip_image_prediction_embedder():
    cfg = _emb_models()[0]["params"]
    x = _batch()["cond_frames_without_noise"]
    jmod = jemb.FrozenOpenCLIPImagePredictionEmbedder(**cfg)
    params = flax_params(jmod, 9, jnp.asarray(x))
    ref = np.asarray(_apply(jmod, params, jnp.asarray(x)))
    with torch.no_grad():
        out = load_port(embedders.FrozenOpenCLIPImagePredictionEmbedder(**cfg),
                        params)(torch.from_numpy(x)).numpy()
    assert out.shape == (T, 1, 24)
    assert rel_l2(out, ref) <= TOL


def test_video_prediction_embedder_with_encoder():
    cfg = _emb_models()[3]["params"]
    x = _batch()["cond_frames"]
    jmod = jemb.VideoPredictionEmbedderWithEncoder(**cfg)
    params = flax_params(jmod, 10, jnp.asarray(x))
    ref = np.asarray(_apply(jmod, params, jnp.asarray(x)))
    port = embedders.VideoPredictionEmbedderWithEncoder(**cfg)
    sd = state_dict_from_flax(params)
    sd.update(kl_decoder_state_dict(cfg["encoder_config"]["params"]["ddconfig"], 11,
                                    "encoder."))
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == (T, H // 8, W // 8, 4)
    assert rel_l2(out, ref) <= TOL


def test_general_conditioner_c_uc():
    """(c, uc) against the JAX package's two conditioner passes, uc with the
    image embeddings zeroed; the port's one-pass uc equals its own second
    pass exactly."""
    emb_models = _emb_models()
    batch = _batch(1)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jmod = jemb.GeneralConditioner(emb_models=emb_models)
    params = flax_params(jmod, 12, jbatch)
    jc, juc = jax.jit(lambda p, b: jmod.apply(
        {"params": p}, b, None, UC_KEYS, method=jmod.get_unconditional_conditioning))(
            params, jbatch)
    port = embedders.GeneralConditioner(emb_models)
    sd = state_dict_from_flax(params)
    sd.update(conditioner_extras(emb_models, 13, prefix=""))
    port.load_state_dict(sd, strict=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        c, uc = port.eval().get_unconditional_conditioning(tbatch, UC_KEYS)
        uc_two_pass = port(tbatch, UC_KEYS)
    want = {"crossattn": (T, 1, 24), "vector": (T, 32), "concat": (T, H // 8, W // 8, 4)}
    assert {k: tuple(v.shape) for k, v in c.items()} == want
    assert {k: tuple(v.shape) for k, v in uc.items()} == want
    for key in want:
        assert rel_l2(c[key].numpy(), np.asarray(jc[key])) <= TOL, key
        torch.testing.assert_close(uc[key], uc_two_pass[key], rtol=0, atol=0)
        if key == "vector":
            assert rel_l2(uc[key].numpy(), np.asarray(juc[key])) <= TOL
        else:
            assert not uc[key].any() and not np.asarray(juc[key]).any()

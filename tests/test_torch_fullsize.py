"""The flagship VideoUNet (configs/base/svd_gcd.yaml:30-50: 320 channels,
mult [1, 2, 4, 4], 2 res blocks, heads of 64, context 1024, adm 768 + aux
128) and the VideoDecoder (ch 128, mult [1, 2, 4, 4], 2 res blocks, the
(3, 1, 1) time kernel) at full widths and depth, held against the JAX
package in fp32 on the CPU on the same seeded weights, carried across by
the port's weight bridge (`state_dict_from_flax`, strict load).

The full-size cases are `slow` (deselected from tier-1 by -m 'not slow'):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fullsize.py -m slow -k fullsize

They run one video of 2 frames at a reduced latent plane (16 x 24: every
level's plane halves down to 2 x 3). The UNet's 1.5 B fp32 parameters are
6.1 GB; the harness holds them as numpy and, during JAX's call, on JAX's
side too (about 12 GB, estimated from the parameter count), then moves
them to the port leaf by leaf (built on the meta device, loaded with
assign), so at most one copy and a leaf are held there. The same harness
runs in tier-1 at the tiny widths (tests/torch_port_helpers.py TINY_UNET /
TINY_DD).

Bound: the tiny cases read 1.6e-6 (UNet) and 8.0e-7 (decoder) relative L2
in fp32; a full-width layer sums more terms, so the bound is the UNet
tests' 1e-4 (tests/torch_unet_helpers.py TOL), far below any difference of
behaviour.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.models.unet import VideoUNet as JVideoUNet
from gcd_tpu.models.vae import VideoDecoder as JVideoDecoder
from gcd_tpu_torch.io.convert import state_dict_from_flax
from gcd_tpu_torch.models.unet import VideoUNet
from gcd_tpu_torch.models.vae import VideoDecoder
from tests.test_parity_fullsize import FULL_DD, FULL_UNET
from tests.torch_port_helpers import TINY_DD, TINY_UNET, flax_params, nchw, nhwc, rel_l2
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
T = 2


def _port(cls, options: dict, params: dict) -> torch.nn.Module:
    """The port's module built on the meta device and given the converted
    weights themselves (assign: no second copy), each flax leaf dropped as
    soon as it is converted."""
    sd = {}
    for name in list(params):
        sd.update(state_dict_from_flax({name: params.pop(name)}))
        gc.collect()
    with torch.device("meta"):
        port = cls(**options)
    port.load_state_dict(sd, strict=True, assign=True)
    return port.eval()


def _unet_case(options: dict, h: int, w: int, seed: int) -> float:
    rng = np.random.default_rng(seed)
    y_dim = options["adm_in_channels"] + options.get("aux_emb_dim", 0)
    a = dict(x=rng.normal(size=(T, h, w, options["in_channels"])).astype(np.float32),
             ts=rng.uniform(0.5, 700.0, size=(T,)).astype(np.float32),
             ctx=rng.normal(size=(T, 1, options["context_dim"])).astype(np.float32),
             y=rng.normal(size=(T, y_dim)).astype(np.float32),
             ioi=np.zeros((1, T), np.float32))
    jmod = JVideoUNet(**options)
    jargs = [jnp.asarray(a[k]) for k in ("x", "ts", "ctx", "y")]
    kw = dict(num_video_frames=T, image_only_indicator=jnp.asarray(a["ioi"]))
    params = flax_params(jmod, seed, *jargs, **kw)
    want = np.asarray(jax.jit(lambda p, *xs: jmod.apply({"params": p}, *xs, **kw))(
        params, *jargs))
    jax.clear_caches()
    port = _port(VideoUNet, options, params)
    with torch.no_grad():
        got = port(nchw(a["x"]), torch.from_numpy(a["ts"]), torch.from_numpy(a["ctx"]),
                   torch.from_numpy(a["y"]), num_video_frames=T,
                   image_only_indicator=torch.from_numpy(a["ioi"]))
    assert np.abs(want).max() > 1e-2
    return rel_l2(nhwc(got), want)


def _decoder_case(options: dict, h: int, w: int, seed: int) -> float:
    z = np.random.default_rng(seed).normal(size=(T, h, w, options["z_channels"])).astype(
        np.float32)
    jdec = JVideoDecoder(**options, video_kernel_size=[3, 1, 1])
    params = flax_params(jdec, seed, jnp.asarray(z), timesteps=T)
    want = np.asarray(jax.jit(lambda p, z: jdec.apply({"params": p}, z, timesteps=T))(
        params, jnp.asarray(z)))
    jax.clear_caches()
    port = _port(VideoDecoder, dict(options, video_kernel_size=[3, 1, 1]), params)
    with torch.no_grad():
        got = port(nchw(z), T)
    up = 2 ** (len(options["ch_mult"]) - 1)
    assert got.shape[2:] == (up * h, up * w)
    assert np.abs(want).max() > 1e-2
    return rel_l2(nhwc(got), want)


def test_unet_harness_at_tiny_widths():
    assert _unet_case(TINY_UNET, 8, 8, 31) <= TOL


def test_decoder_harness_at_tiny_widths():
    assert _decoder_case(TINY_DD, 8, 8, 32) <= TOL


@pytest.mark.slow
def test_fullsize_unet_matches_jax():
    assert _unet_case(FULL_UNET, 16, 24, 33) <= TOL


@pytest.mark.slow
def test_fullsize_video_decoder_matches_jax():
    assert _decoder_case(FULL_DD, 16, 24, 34) <= TOL

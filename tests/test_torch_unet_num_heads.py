"""A VideoUNet built with `num_heads` rather than `num_head_channels` (both
packages accept it: gcd_tpu/models/unet.py `_attn`, gcd_tpu_torch's
`attn`): head sizes that are not multiples of 16, over 40 frames.

On the CPU the port's attention runs its plain versions; on the card K2's
general family takes these heads at any T and K1's route sends them to
`ops/basic.dot_product_attention`, as JAX's `_xla_attention` takes them.
The tiny UNet (8 heads: of 4 and 8 channels) is held against JAX in fp32 at
the UNet tests' 1e-4 (tests/torch_unet_helpers.py TOL); the flagship's
`num_heads: 8` layout (SD 1.x's heads of 40, 80 and 160 at 320, 640 and
1280 channels) is checked on the meta device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gcd_tpu.models.unet import VideoUNet as JVideoUNet
from gcd_tpu_torch.models.attention import CrossAttention, TemporalSelfAttention
from gcd_tpu_torch.models.unet import VideoUNet
from gcd_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS
from gcd_tpu_torch.ops.temporal_attention import kernel_family
from tests.test_parity_fullsize import FULL_UNET
from tests.torch_port_helpers import TINY_UNET, flax_params, load_port, nchw, nhwc, rel_l2
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
T, H, W = 40, 4, 4


def _head_sizes(unet, cls):
    return sorted({m.dim_head for m in unet.modules() if isinstance(m, cls)})


def test_num_heads_unet_over_40_frames_matches_jax():
    options = {**TINY_UNET, "num_heads": 8, "num_head_channels": -1}
    rng = np.random.default_rng(41)
    y_dim = TINY_UNET["adm_in_channels"] + TINY_UNET["aux_emb_dim"]
    x = rng.normal(size=(T, H, W, 8)).astype(np.float32)
    ts = rng.normal(size=(T,)).astype(np.float32) * 3.0
    ctx = rng.normal(size=(T, 5, 24)).astype(np.float32)
    y = rng.normal(size=(T, y_dim)).astype(np.float32)
    ioi = np.zeros((1, T), np.float32)
    ioi[0, 7] = 1.0
    jmod = JVideoUNet(**options)
    jargs = tuple(map(jnp.asarray, (x, ts, ctx, y)))
    kw = dict(num_video_frames=T, image_only_indicator=jnp.asarray(ioi))
    params = flax_params(jmod, 42, *jargs, **kw)
    want = np.asarray(jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, **kw))(
        params, *jargs))
    port = load_port(VideoUNet(**options), params)
    heads = _head_sizes(port, TemporalSelfAttention)
    assert heads == [4, 8] == _head_sizes(port, CrossAttention)
    assert all(kernel_family(T, d) == "general" and d not in KERNEL_HEAD_DIMS for d in heads)
    with torch.no_grad():
        got = port(nchw(x), torch.from_numpy(ts), torch.from_numpy(ctx), torch.from_numpy(y),
                   num_video_frames=T, image_only_indicator=torch.from_numpy(ioi))
    assert np.abs(want).max() > 1e-2
    assert rel_l2(nhwc(got), want) <= TOL


def test_flagship_num_heads_8_layout():
    """svd_gcd's widths with `num_heads: 8`: heads of 40, 80 and 160 in the
    temporal and spatial attention alike; K2 takes 40 and 160 in its
    general family and 80 in its narrow one at the clip's 14 frames, and in
    the general family past 32 frames; no spatial head is K1's."""
    options = {**FULL_UNET, "num_heads": 8, "num_head_channels": -1}
    with torch.device("meta"):
        unet = VideoUNet(**options)
    heads = _head_sizes(unet, TemporalSelfAttention)
    assert heads == [40, 80, 160]
    assert _head_sizes(unet, CrossAttention) == heads
    assert [kernel_family(14, d) for d in heads] == ["general", "narrow", "general"]
    assert {kernel_family(64, d) for d in heads} == {"general"}
    assert not set(heads) & set(KERNEL_HEAD_DIMS)

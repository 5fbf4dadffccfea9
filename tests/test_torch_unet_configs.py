"""The card's two option UNets (chip_smoke.py's conditioning phase (d)),
whole, against the JAX VideoUNet, and a gradient of A against jax.grad; the
JAX package's defaults for the keys a config leaves out;
the bf16 route of cross-attention to a 77-token context; the frame-group
refusal of a time kernel with spatial extent. Weights carried by the weight
bridge and loaded with strict=True; fp32 on the CPU at 1e-4, as
the other tests/test_torch_unet_*.py (tests/torch_unet_helpers.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.models.attention import CrossAttention as JCrossAttention
from gcd_tpu.models.unet import VideoUNet as JVideoUNet
from gcd_tpu_torch.io.convert import state_dict_from_flax
from gcd_tpu_torch.models.attention import CrossAttention
from gcd_tpu_torch.models.unet import VideoUNet
from gcd_tpu_torch.parallel.frames import FrameGroup, frame_sharding
from tests.torch_port_helpers import TINY_UNET, flax_params, load_port, nchw, nhwc, rel_l2
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_unet_helpers import (
    B,
    CONFIG_A,
    CONFIG_B,
    DEFAULTED,
    H,
    T,
    TOL,
    W,
    check_option,
    inputs,
    jax_apply,
    jax_args,
    jax_kwargs,
    port_call,
    unet_pair,
)


@pytest.mark.parametrize("name,options", [("A", CONFIG_A), ("B", CONFIG_B)])
def test_config_matches_jax(name, options):
    port = check_option(options, 5)
    if name == "B":
        # No attn2 in the temporal blocks.
        keys = port.state_dict()
        assert not any(".time_stack.0.attn2." in k or ".time_stack.0.norm2." in k
                       for k in keys)


def test_config_a_gradient_matches_jax():
    """One gradient of A's output, dotted with a fixed cotangent, with
    respect to every parameter, against jax.grad."""
    jmod, params, port = unet_pair(CONFIG_A, 6)
    a = inputs(106)
    kw = jax_kwargs(a, False)
    cot = np.random.default_rng(7).normal(size=(B * T, H, W, 4)).astype(np.float32)

    def loss(p):
        return jnp.sum(jmod.apply({"params": p}, *jax_args(a), **kw) * cot)

    grads = jax.jit(jax.grad(loss))(params)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    out = port_call(port, a)
    (out * nchw(cot)).sum().backward()
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want)
    flat_got = torch.cat([got[k].flatten() for k in sorted(got)]).numpy()
    flat_want = torch.cat([want[k].flatten() for k in sorted(want)]).numpy()
    assert rel_l2(flat_got, flat_want) <= TOL
    # Each sizeable block of the gradient on its own, too.
    for k in sorted(got):
        if np.linalg.norm(want[k].numpy()) > 1e-3 * np.linalg.norm(flat_want):
            assert rel_l2(got[k].numpy(), want[k].numpy()) <= 1e-3, k


def test_defaults_are_jax_defaults():
    """A config that leaves out the four keys builds JAX's network: fixed
    blends, a (3, 3, 3) time kernel, conv projections, no per-frame
    temporal context."""
    options = {k: v for k, v in TINY_UNET.items() if k not in DEFAULTED}
    jmod = JVideoUNet(**options)
    a = inputs(8)
    kw = jax_kwargs(a, False)
    params = flax_params(jmod, 8, *jax_args(a), **kw)
    ref = jax_apply(jmod, params, a, kw)
    port = load_port(VideoUNet(**options), params)
    with torch.no_grad():
        out = port_call(port, a)
    assert rel_l2(nhwc(out), ref) <= TOL
    sd = port.state_dict()
    assert not any(k.endswith("mix_factor") for k in sd)
    assert sd["input_blocks.1.0.time_stack.in_layers.2.weight"].shape[2:] == (3, 3, 3)
    assert sd["input_blocks.1.1.proj_in.weight"].dim() == 4


def test_cross_attention_bf16_text_context():
    """bf16 cross-attention of 2 x 384 queries to 77 keys, 5 heads of 64,
    against JAX's bf16 module. The attention itself (the module with to_out
    taken out, on its own q, k, v) is held against JAX's _xla_attention on
    JAX's q, k, v at 2e-4: normalised in fp32 then cast (1.9e-5 here),
    where K1's plain rounding, the route before, sits 3.0e-3 away. The whole
    module differs more, 2.7e-3, on either route: JAX on the CPU rounds
    to_out's product to bf16 before adding its bias, torch's addmm adds the
    bias before its one rounding."""
    from gcd_tpu.ops.attention import _xla_attention
    from gcd_tpu_torch.ops.flash_attention import flash_attention_plain

    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 384, 320)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, 1024)).astype(np.float32)
    jmod = JCrossAttention(heads=5, dim_head=64, context_dim=1024, dtype=jnp.bfloat16)
    params = flax_params(jmod, 10, jnp.asarray(x), jnp.asarray(ctx))
    xb, cb = (jnp.asarray(v, jnp.bfloat16) for v in (x, ctx))
    ref = np.asarray(jmod.apply({"params": params}, xb, cb).astype(jnp.float32))
    qkv = [inp @ jnp.asarray(params[name]["kernel"], jnp.bfloat16)
           for name, inp in (("to_q", xb), ("to_k", cb), ("to_v", cb))]
    core_ref = np.asarray(_xla_attention(*(z.reshape(2, -1, 5, 64) for z in qkv))
                          .astype(jnp.float32)).reshape(2, 384, 320)

    port = load_port(CrossAttention(320, 5, 64, 1024), params).to(torch.bfloat16)
    xt, ct = torch.from_numpy(x).bfloat16(), torch.from_numpy(ctx).bfloat16()
    with torch.no_grad():
        out = port(xt, ct)
        # The module's attention on JAX's q, k, v: projections that return them.
        q, k, v = (torch.from_numpy(np.asarray(z.astype(jnp.float32))).bfloat16()
                   for z in qkv)
        port.to_q, port.to_k, port.to_v = (_Given(z) for z in (q, k, v))
        port.to_out = torch.nn.Sequential(torch.nn.Identity())
        core = port(xt, ct)
        old = flash_attention_plain(q, k, v, 5)
    assert out.dtype == core.dtype == torch.bfloat16
    assert rel_l2(core.float().numpy(), core_ref) <= 2e-4
    assert rel_l2(old.float().numpy(), core_ref) > 1e-3
    assert rel_l2(out.float().numpy(), ref) <= 5e-3


class _Given(torch.nn.Module):
    """A projection that returns the tensor it was given."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def forward(self, _):
        return self.out


def test_time_kernel_with_spatial_extent_refuses_a_frame_group():
    port = VideoUNet(**{**TINY_UNET, "video_kernel_size": 3}).eval()
    a = inputs(11)
    with torch.no_grad(), frame_sharding(FrameGroup(None, 1, 0, T)):
        with pytest.raises(NotImplementedError, match="video_kernel_size"):
            port_call(port, a)


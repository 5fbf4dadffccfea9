"""K7 (ops/fused_gn_conv.py) on the CPU: the plain chain against the JAX
package's Pallas kernel and its XLA chain, the Function's gradient against
jax.vjp, and the 2D ResBlock's K7 route against JAX's ResBlock with
`fused_gn_conv` on.

The JAX side runs `_fused_forward` (K7's Pallas kernel) in TPU interpret
mode and `_xla_chain`, with NHWC inputs; the port takes the same numpy
values as (N, C, H, W). fp32 throughout: the sums differ only in order
(~1e-7 relative), against a bound of 1e-4 (1e-5 for the gradient's
inputs, whose chains are shorter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcd_tpu.models.resblock import ResBlock as JResBlock
from gcd_tpu.ops import dispatch as jdispatch
from gcd_tpu.ops import fused_gn_conv as jgc
from gcd_tpu_torch.models import resblock as port_resblock
from gcd_tpu_torch.models.resblock import ResBlock
from gcd_tpu_torch.ops import (
    KERNELS,
    gn_silu_conv3x3,
    gn_silu_conv3x3_plain,
    kernel_enabled,
    kernel_flags,
)
from gcd_tpu_torch.ops.fused_gn_conv import (
    BLOCK_FILTERS,
    BLOCK_PIXELS,
    CHUNK,
    HALO_MAX,
    SAMPLES_MAX,
    supported,
    tile_plan,
)
from tests.torch_port_helpers import flax_params, load_port, nchw, nhwc, rel_l2
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
G = 32
H100_SMS = 132  # the SMs of an H100 SXM, for which the plans below are made
# (N, H, W, C, F): the shapes of tests/test_fused_mlp.py's K7 interpret test.
SHAPES = [(2, 8, 16, 128, 256), (1, 8, 24, 320, 320)]


def _inputs(n, h, w, c, f, seed, const_value=None):
    """NHWC x, GN scale / bias, HWIO kernel and conv bias as numpy fp32.
    With `const_value`, channels of group 0 in sample 0 all hold it."""
    rng = np.random.default_rng(seed)
    x = (0.5 + 2.0 * rng.normal(size=(n, h, w, c))).astype(np.float32)
    if const_value is not None:
        x[0, ..., : c // G] = const_value
    scale = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=c)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, c, f)) * (9 * c) ** -0.5).astype(np.float32)
    bk = (0.1 * rng.normal(size=f)).astype(np.float32)
    return x, scale, bias, wk, bk


def _port_args(x, scale, bias, wk, bk):
    return (nchw(x), torch.from_numpy(scale), torch.from_numpy(bias),
            torch.from_numpy(np.ascontiguousarray(wk.transpose(3, 2, 0, 1))),
            torch.from_numpy(bk))


def _jax_chain(args, eps, silu):
    return np.asarray(jgc._xla_chain(*map(jnp.asarray, args), G, eps, silu))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("silu", [True, False])
def test_plain_matches_tpu_kernel_and_xla_chain(shape, silu):
    args = _inputs(*shape, seed=0)
    out = nhwc(gn_silu_conv3x3_plain(*_port_args(*args), G, 1e-5, silu))
    with pltpu.force_tpu_interpret_mode():
        k7 = np.asarray(jgc._fused_forward(*map(jnp.asarray, args), G, 1e-5, silu,
                                           shape[-1]))
    assert rel_l2(out, _jax_chain(args, 1e-5, silu)) <= TOL
    assert rel_l2(out, k7) <= TOL


def test_constant_group_clamps_the_variance():
    """A group of equal values whose fp32 variance comes out below -eps
    (F2): the clamp keeps it finite, as the TPU kernel's own clamp does."""
    n, h, w, c, f = 2, 4, 6, 64, 64
    args = _inputs(n, h, w, c, f, seed=1, const_value=333.3)
    xf = args[0][0, ..., : c // G].astype(np.float32).reshape(-1)
    mean = np.float32(xf.sum(dtype=np.float32) / np.float32(xf.size))
    var = np.float32((xf * xf).sum(dtype=np.float32) / np.float32(xf.size)) - mean * mean
    assert var < -1e-6  # the case the clamp exists for
    out = nhwc(gn_silu_conv3x3_plain(*_port_args(*args), G, 1e-6, True))
    with pltpu.force_tpu_interpret_mode():
        k7 = np.asarray(jgc._fused_forward(*map(jnp.asarray, args), G, 1e-6, True, f))
    assert np.isfinite(out).all()
    assert rel_l2(out, _jax_chain(args, 1e-6, True)) <= TOL
    assert rel_l2(out, k7) <= TOL


def test_gradient_of_all_five_inputs_matches_jax_vjp():
    args = _inputs(2, 4, 6, 64, 128, seed=2)
    g = np.random.default_rng(3).normal(size=(2, 4, 6, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jgc._xla_chain(*a, G, 1e-5, True), *map(jnp.asarray, args))
    want = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    port = [t.requires_grad_() for t in _port_args(*args)]
    out = gn_silu_conv3x3(*port, G, 1e-5, True)
    grads = torch.autograd.grad(out, port, nchw(g))
    got = [nhwc(grads[0]), grads[1].numpy(), grads[2].numpy(),
           grads[3].numpy().transpose(2, 3, 1, 0), grads[4].numpy()]
    for name, a, b in zip(("x", "gn_weight", "gn_bias", "conv_weight", "conv_bias"), got, want):
        assert a.shape == b.shape, name
        assert rel_l2(a, b) <= 1e-5, name


def _resblock_case(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 4, 6, 64)).astype(np.float32)
    emb = rng.normal(size=(2, 48)).astype(np.float32)
    jmod = JResBlock(out_channels=128)
    with jdispatch.kernel_flags(fused_gn_conv=True):
        params = flax_params(jmod, seed + 1, jnp.asarray(x), jnp.asarray(emb))
        ref = np.asarray(jax.jit(lambda p, a, e: jmod.apply({"params": p}, a, e))(
            params, jnp.asarray(x), jnp.asarray(emb)))
    port = load_port(ResBlock(64, 48, 128), params)
    return port, nchw(x), torch.from_numpy(emb), ref


def test_resblock_route_matches_jax_with_fused_gn_conv(monkeypatch):
    port, x, emb, ref = _resblock_case(4)
    calls = []
    real = port_resblock.gn_silu_conv3x3

    def spy(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)

    monkeypatch.setattr(port_resblock, "gn_silu_conv3x3", spy)
    with torch.no_grad():
        on = port(x, emb)
        assert calls == [(2, 64, 4, 6), (2, 128, 4, 6)]  # in_layers, out_layers
        with kernel_flags(fused_gn_conv=False):
            off = port(x, emb)
    assert len(calls) == 2
    assert rel_l2(nhwc(on), ref) <= TOL
    assert rel_l2(nhwc(on), nhwc(off)) <= 1e-5


def test_time_stack_and_unsupported_shapes_keep_groupnorm_and_conv(monkeypatch):
    calls = []
    monkeypatch.setattr(port_resblock, "gn_silu_conv3x3", lambda *a, **k: calls.append(1))
    block = port_resblock.VideoResBlock(32, 16, 32).eval()  # C = 32: not K7's shape
    with torch.no_grad():
        block(torch.randn(6, 32, 4, 4), torch.randn(6, 16), torch.zeros(2, 3), 3)
    assert calls == []
    assert len(block.fused_convs()) == 2 and block.time_stack.fused_convs() == []


def test_channels_last_conv_weights():
    """Built channels_last, and kept so through the dtype cast, the
    materialisation and a state-dict load."""
    with torch.device("meta"):
        block = port_resblock.VideoResBlock(64, 16, 64)
    block = block.to(torch.bfloat16).to_empty(device="cpu")
    block.load_state_dict({k: torch.randn(v.shape).contiguous()
                           for k, v in block.state_dict().items()})
    for conv in block.fused_convs():
        assert not conv.weight.is_contiguous()
        assert conv.weight.is_contiguous(memory_format=torch.channels_last)
    assert block.time_stack.in_layers[2].weight.is_contiguous()


def test_supported_and_cpu_routing():
    def sup(x_shape, w_shape, groups=G):
        return supported(torch.empty(x_shape, device="meta"),
                         torch.empty(w_shape, device="meta"), groups)

    assert sup((28, 320, 32, 48), (320, 320, 3, 3))
    assert sup((28, 2560, 4, 6), (1280, 2560, 3, 3))
    assert not sup((28, 32, 8, 8), (64, 32, 3, 3))        # C % 64
    assert not sup((28, 320, 8, 8), (96, 320, 3, 3))      # F % 64
    assert not sup((28, 320, 8, 8), (320, 320, 1, 1))     # not 3x3
    assert not sup((28, 320, 8, 8), (320, 640, 3, 3))     # C mismatch
    assert not sup((2, 320, 3, 8, 8), (320, 320, 3, 3))   # 5D
    assert not sup((28, 320, 8, 8), (320, 320, 3, 3), 30)  # groups
    assert kernel_enabled("fused_gn_conv") and "fused_gn_conv" in KERNELS
    args = _port_args(*_inputs(1, 4, 4, 64, 64, seed=5))
    before = {name: fn.launches for name, fn in KERNELS.items()}
    torch.testing.assert_close(gn_silu_conv3x3(*args), gn_silu_conv3x3_plain(*args),
                               rtol=0, atol=0)
    assert {name: fn.launches for name, fn in KERNELS.items()} == before


# --- The kernel's tiling, modelled on the CPU -------------------------------
#
# K7's CUDA kernel (csrc/fused_gn_conv.cu) cannot run here. What it does
# around its products is modelled below in plain torch and held against the
# plain chain and the Pallas kernel: each block normalises the halo tile of
# its output pixels once per 64-channel chunk (the per-(sample, channel)
# scale and shift from the group sums, zero off the plane after the norm),
# gathers the nine shifted windows of it, and sums its chunk split; the
# splits are added in split order, then the bias. fp32, so the model and
# the references differ only in summation order (~1e-7): TOL (1e-4) holds.


def _blocks(plan, n, h, w):
    """(first sample, first row, first column) of each pixel tile, in the
    kernel's blockIdx.x order."""
    ty, tx = -(-h // plan.rows), -(-w // plan.cols)
    for b in range(-(-n // plan.samples) * ty * tx):
        nb, rem = divmod(b, ty * tx)
        yield nb * plan.samples, (rem // tx) * plan.rows, (rem % tx) * plan.cols


def _chunk_ranges(plan, c):
    chunks = c // CHUNK
    return [range(s * chunks // plan.splits, (s + 1) * chunks // plan.splits)
            for s in range(plan.splits)]


def _k7_model(x, gamma, beta, wk, bk, groups, eps, silu):
    """x (N, C, H, W), wk (F, C, 3, 3): the kernel's algorithm, fp32."""
    n, c, h, w = x.shape
    f = wk.shape[0]
    plan = tile_plan(n, h, w, c, f, H100_SMS)
    xs = x.permute(0, 2, 3, 1)
    grouped = xs.reshape(n, -1, groups, c // groups)
    count = h * w * (c // groups)
    mean = grouped.sum((1, 3)) / count
    inv = torch.rsqrt(torch.clamp(grouped.square().sum((1, 3)) / count - mean.square(), min=0)
                      + eps)
    scale = torch.repeat_interleave(inv, c // groups, 1) * gamma
    shift = beta - torch.repeat_interleave(mean, c // groups, 1) * scale
    wt = wk.permute(0, 2, 3, 1).reshape(f, 9, c)
    out = torch.full((n, h, w, f), float("nan"))
    rows, cols, ns = plan.rows, plan.cols, plan.samples
    for n0, y0, x0 in _blocks(plan, n, h, w):
        # The halo tile: the samples, rows and columns it covers, clamped for
        # the gather, then zeroed off the plane after the normalisation.
        si = torch.arange(n0, n0 + ns)[:, None, None]
        yi = torch.arange(y0 - 1, y0 + rows + 1)[None, :, None]
        xi = torch.arange(x0 - 1, x0 + cols + 1)[None, None, :]
        inside = (si < n) & (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        raw = xs[si.clamp(max=n - 1), yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        sc, sh = scale[si.clamp(max=n - 1)], shift[si.clamp(max=n - 1)]
        t = raw * sc + sh
        a = torch.where(inside[..., None], t * torch.sigmoid(t) if silu else t, 0.0)
        for f0 in range(0, f, BLOCK_FILTERS):
            fs = slice(f0, min(f, f0 + BLOCK_FILTERS))
            total = None
            for chunk_range in _chunk_ranges(plan, c):
                acc = torch.zeros(ns, rows, cols, fs.stop - f0)
                for ch in chunk_range:
                    cs = slice(ch * CHUNK, (ch + 1) * CHUNK)
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        acc += a[:, dy:dy + rows, dx:dx + cols, cs] @ wt[fs, tap, cs].T
                total = acc if total is None else total + acc
            total = total + bk[fs]
            ne, ye, xe = min(ns, n - n0), min(rows, h - y0), min(cols, w - x0)
            out[n0:n0 + ne, y0:y0 + ye, x0:x0 + xe, fs] = total[:ne, :ye, :xe]
    return out.permute(0, 3, 1, 2)


# (N, H, W, C, F): a 4x6 plane (several samples a block, split-K), an odd
# plane with a ragged filter tile (192 = 160 + 32), a plane larger than a
# block with ragged row and column tiles.
MODEL_SHAPES = [(3, 4, 6, 128, 64), (2, 5, 7, 128, 192), (1, 15, 20, 64, 64)]


@pytest.mark.parametrize("shape", MODEL_SHAPES)
@pytest.mark.parametrize("silu", [True, False])
def test_tiling_model_matches_plain_chain_and_tpu_kernel(shape, silu):
    args = _inputs(*shape, seed=6)
    port = _port_args(*args)
    model = _k7_model(*port, G, 1e-5, silu)
    assert torch.isfinite(model).all()
    plain = gn_silu_conv3x3_plain(*port, G, 1e-5, silu)
    assert rel_l2(model.numpy(), plain.numpy()) <= TOL
    with pltpu.force_tpu_interpret_mode():
        k7 = np.asarray(jgc._fused_forward(*map(jnp.asarray, args), G, 1e-5, silu, shape[-1]))
    assert rel_l2(nhwc(model), k7) <= TOL


def test_tiling_model_plan_shapes():
    """The model runs the plans it means to: split-K and several samples a
    block at 4x6, a ragged filter tile, ragged pixel tiles."""
    assert tile_plan(3, 4, 6, 128, 64, H100_SMS) == (4, 6, 3, 2)
    # one pixel tile, two filter tiles
    assert tile_plan(2, 5, 7, 128, 192, H100_SMS) == (5, 7, 2, 2)
    plan = tile_plan(1, 15, 20, 64, 64, H100_SMS)
    assert plan.samples == 1 and 15 % plan.rows and 20 % plan.cols


# The UNet's K7 shapes (one clip after CFG, N = 28, and a served batch, 56)
# and the model's.
PLAN_SHAPES = ([(nn, h, w, c, f) for nn in (28, 56) for h, w, c, f in
                [(32, 48, 320, 320), (32, 48, 960, 320), (16, 24, 640, 640),
                 (8, 12, 1280, 1280), (4, 6, 1280, 1280), (4, 6, 2560, 1280)]]
               + [(s[0], s[1], s[2], s[3], s[4]) for s in MODEL_SHAPES])


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_tile_plan_covers_every_output_once(shape):
    n, h, w, c, f = shape
    plan = tile_plan(n, h, w, c, f, H100_SMS)
    assert plan.rows * plan.cols * plan.samples <= BLOCK_PIXELS
    assert plan.samples <= SAMPLES_MAX
    assert plan.samples * (plan.rows + 2) * (plan.cols + 2) <= HALO_MAX
    cover = torch.zeros(n, h, w, dtype=torch.int32)
    for n0, y0, x0 in _blocks(plan, n, h, w):
        cover[n0:n0 + plan.samples, y0:y0 + plan.rows, x0:x0 + plan.cols] += 1
    assert bool((cover == 1).all())
    chunks = [ch for r in _chunk_ranges(plan, c) for ch in r]
    assert chunks == list(range(c // CHUNK)) and all(len(r) for r in _chunk_ranges(plan, c))
    if (n, h, w) == (28, 4, 6):
        assert plan.splits > 1  # 48 blocks alone would leave most of the SMs idle


def test_tiling_constants_match_the_kernel():
    """tile_plan's mirrors of the CUDA kernel's tiling constants."""
    import re
    from pathlib import Path

    src = (Path(__file__).resolve().parent.parent / "gcd_tpu_torch" / "csrc"
           / "fused_gn_conv.cu").read_text()
    consts = {m[0]: m[1] for m in re.findall(r"constexpr int (\w+) = ([^;]+);", src)}
    cuda = {name: eval(expr, {}, {k: int(v) for k, v in consts.items() if v.isdigit()})
            for name, expr in consts.items() if name in ("BM", "BN", "CK", "HALO_MAX", "NS_MAX")}
    assert cuda == {"BM": BLOCK_PIXELS, "BN": BLOCK_FILTERS, "CK": CHUNK,
                    "HALO_MAX": HALO_MAX, "NS_MAX": SAMPLES_MAX}


@pytest.mark.parametrize("shape", [(3, 64, 4, 6), (2, 128, 5, 7)])
def test_scale_shift_table_normalises_as_group_norm(shape):
    """K7's (scale, shift) table, in its plain version (the CUDA one is K5's
    finalize pass): x * scale + shift is the GroupNorm without SiLU."""
    from gcd_tpu_torch.ops.fused_norm import group_norm_plain, group_scale_shift_plain

    rng = np.random.default_rng(8)
    n, c, h, w = shape
    x = torch.from_numpy((0.5 + 2.0 * rng.normal(size=shape)).astype(np.float32))
    gamma = torch.from_numpy((1.0 + 0.1 * rng.normal(size=c)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.normal(size=c)).astype(np.float32))
    table = group_scale_shift_plain(x, gamma, beta, G, 1e-5)
    assert table.shape == (n, c, 2) and table.dtype == torch.float32
    y = x * table[..., 0, None, None] + table[..., 1, None, None]
    assert rel_l2(y.numpy(), group_norm_plain(x, gamma, beta, G, 1e-5, False).numpy()) <= TOL

"""The port's training pieces on the CPU against the JAX package: the
flash-attention backward (K6's plain version), the gradients of the K2 / K3
/ K4 autograd Functions, StandardDiffusionLoss (and its mask downsample
where the latent grid does not divide), the sampled first-stage
encoding, the conditioning dropout, remat's recompute, and the optimizer
mapping.

fp32 unless a case says otherwise, JAX at jax_default_matmul_precision
highest (conftest). Where both sides compute the same fp32 sums in another
order they agree to ~1e-7 relative; the 1e-5 bounds leave two orders of
margin. Bounds that differ say why beside them.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcd_tpu.diffusion.loss import PERSON_RGB, VEHICLE_RGB
from gcd_tpu.ops import fused_norm as jfn
from gcd_tpu.ops.flash_attention import flash_attention_bwd as j_flash_bwd
from gcd_tpu.ops.fused_mlp import geglu_mlp as j_geglu
from gcd_tpu.ops.temporal_attention import temporal_attention as j_temporal
from gcd_tpu.utils.config import instantiate_from_config as j_instantiate
from gcd_tpu_torch.diffusion.loss import _area_downsample
from gcd_tpu_torch.engine.build import load_engine
from gcd_tpu_torch.engine.trainer import load_trainer, optimizer_from_config
from gcd_tpu_torch.models.layers import GroupNorm32
from gcd_tpu_torch.models.unet import VideoUNet
from gcd_tpu_torch.ops import (
    KERNELS,
    flash_attention,
    flash_attention_bwd_plain,
    geglu_mlp,
    group_norm,
    kernel_enabled,
    kernel_flags,
    temporal_attention,
)
from gcd_tpu_torch.utils.config import instantiate_from_config, load_config
from tests.torch_port_helpers import (
    TINY_CONFIG,
    TINY_UNET,
    engine_params,
    engine_state_dict,
    rel_l2,
    tiny_batch,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
G = 32


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_plain_matches_tpu_kernel(dtype):
    """K6's plain version against the Pallas backward kernel in interpret
    mode at (2, 384, 2x64). fp32: 2e-4, as tests/test_flash_attention.py
    holds the kernel. bf16: inputs, dS and the results are bf16 on both
    sides, and a last-bit difference in the fp32 P can round dS to the
    neighbouring bf16 value (3.9e-3 apart); 1e-2 relative."""
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.normal(size=(2, 384, 128)).astype(np.float32) for _ in range(4))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = j_flash_bwd(*(jnp.asarray(a, jdt) for a in (q, k, v, g)), 64 ** -0.5, 2,
                      interpret=True)
    out = flash_attention_bwd_plain(*(_t(a).to(tdt) for a in (q, k, v, g)), 2)
    tol = 2e-4 if dtype == "float32" else 1e-2
    for got, want in zip(out, ref):
        assert got.dtype == tdt
        assert rel_l2(got.float().numpy(), np.asarray(want, np.float32)) <= tol


def test_flash_attention_function_backward_is_the_plain_backward():
    """On the CPU the K1 Function's gradient is flash_attention_bwd_plain's,
    whichever switch is set at backward time; it records the flash_bwd
    switch of the forward's thread."""
    rng = np.random.default_rng(1)
    q, k, v, g = (rng.normal(size=(2, 40, 128)).astype(np.float32) for _ in range(4))
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    with kernel_flags(flash_bwd=False):
        out = flash_attention(qt, kt, vt, 2)
    assert out.grad_fn.flash_bwd is False
    before = {name: fn.launches for name, fn in KERNELS.items()}
    out.backward(_t(g))
    want = flash_attention_bwd_plain(_t(q), _t(k), _t(v), _t(g), 2)
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    assert {name: fn.launches for name, fn in KERNELS.items()} == before


def _vjp(fn, primals, cot):
    out, vjp = jax.vjp(fn, *(jnp.asarray(p) for p in primals))
    return np.asarray(out), [np.asarray(gr) for gr in vjp(jnp.asarray(cot))]


def test_temporal_attention_gradients_match_jax():
    rng = np.random.default_rng(2)
    b, t, s, heads, d = 2, 3, 5, 2, 8
    q, k, v, g = (rng.normal(size=(b * t, s, heads * d)).astype(np.float32)
                  for _ in range(4))
    ref, ref_grads = _vjp(lambda *a: j_temporal(*a, t, heads), (q, k, v), g)
    ins = [_t(a, True) for a in (q, k, v)]
    out = temporal_attention(*ins, t, heads)
    out.backward(_t(g))
    assert rel_l2(out.detach().numpy(), ref) <= TOL
    for x, want in zip(ins, ref_grads):
        assert rel_l2(x.grad.numpy(), want) <= TOL


def test_geglu_mlp_gradients_match_jax():
    """The gradient recomputes the erf GELU the forward uses (F1), as the
    JAX rule does off the TPU."""
    rng = np.random.default_rng(3)
    m, c, inner, c_out = 12, 16, 64, 24
    x = rng.normal(size=(2, m // 2, c)).astype(np.float32)
    w1 = rng.normal(0, c ** -0.5, (c, 2 * inner)).astype(np.float32)
    b1 = rng.normal(0, 0.5, (2 * inner,)).astype(np.float32)
    w2 = rng.normal(0, inner ** -0.5, (inner, c_out)).astype(np.float32)
    b2 = rng.normal(0, 0.5, (c_out,)).astype(np.float32)
    g = rng.normal(size=(2, m // 2, c_out)).astype(np.float32)
    ref, (gx, gw1, gb1, gw2, gb2) = _vjp(j_geglu, (x, w1, b1, w2, b2), g)
    ins = [_t(x, True), _t(w1.T, True), _t(b1, True), _t(w2.T, True), _t(b2, True)]
    out = geglu_mlp(*ins)
    out.backward(_t(g))
    assert rel_l2(out.detach().numpy(), ref) <= TOL
    for got, want in zip([a.grad for a in ins], (gx, gw1.T, gb1, gw2.T, gb2)):
        assert rel_l2(got.numpy(), want) <= TOL


@pytest.mark.parametrize("shape,const_group", [((2, 4, 6, 64), False),
                                               ((2, 3, 4, 6, 64), False),
                                               ((2, 4, 6, 64), True)])
def test_group_norm_gradients_match_jax(shape, const_group):
    """K4's Function against jax.vjp of fused_group_norm (the Pallas kernel
    in interpret mode, the vjp of _reference_groupnorm). The port's input is
    channels-last in memory and its incoming gradient a permuted view, as
    convolutions hand them over; const_group makes a group's variance 0,
    where the clamp (F2) holds."""
    rng = np.random.default_rng(4)
    x = (0.5 + 2.0 * rng.normal(size=shape)).astype(np.float32)
    c = shape[-1]
    if const_group:
        x[0, ..., : c // G] = 3.0
    scale = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=c)).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, (gx, gs, gb) = _vjp(lambda *a: jfn.fused_group_norm(*a, G, 1e-6, True),
                                 (x, scale, bias), g)
    # (N, ..., C) buffers viewed as (N, C, ...): channels-last memory.
    xt = _t(x).movedim(-1, 1).requires_grad_(True)
    ws, wb = _t(scale, True), _t(bias, True)
    out = group_norm(xt, ws, wb, G, 1e-6, True)
    out.backward(_t(g).movedim(-1, 1))
    assert np.isfinite(xt.grad.numpy()).all()
    assert rel_l2(out.detach().movedim(1, -1).numpy(), ref) <= TOL
    assert rel_l2(xt.grad.movedim(1, -1).numpy(), gx) <= TOL
    assert rel_l2(ws.grad.numpy(), gs) <= TOL
    assert rel_l2(wb.grad.numpy(), gb) <= TOL


# ---------------------------------------------------------------------------
# StandardDiffusionLoss
# ---------------------------------------------------------------------------

LOSS_T, LOSS_B, LOSS_HW = 3, 2, (16, 24)


def _loss_config(pd: bool):
    cfg = load_config(TINY_CONFIG)["model"]["params"]["loss_fn_config"]
    cfg["params"].update(focus_steps=5000, offset_noise_level=0.1 if pd else 0.0)
    if pd:
        cfg["params"].update(pd_person_weight=2.0, pd_vehicle_weight=3.0)
    return cfg


def _loss_inputs():
    """Latents, a camera-free cond, and frames where some 8x8 patches carry
    ParallelDomain class colours (some whole, some partial)."""
    rng = np.random.default_rng(5)
    bt, (h, w) = LOSS_B * LOSS_T, LOSS_HW
    x = rng.normal(size=(bt, h // 8, w // 8, 4)).astype(np.float32)
    jpg = rng.uniform(-1, 1, (bt, h, w, 3)).astype(np.float32)
    colours = PERSON_RGB + VEHICLE_RGB
    for i in range(bt):
        col = np.asarray(colours[(3 * i) % len(colours)], np.float32) / 127.5 - 1.0
        jpg[i, :8, :8] = col
        jpg[i, 8:12, 8:16] = np.asarray(colours[(3 * i + 1) % len(colours)]) / 127.5 - 1.0
    cond = {"vector": rng.normal(size=(bt, 8)).astype(np.float32)}
    return x, jpg, cond


def _toy_network(xin, c_noise, cond, xp):
    """A smooth stand-in for the UNet, the same on both sides."""
    v = cond["vector"].mean(axis=-1) if xp is jnp else cond["vector"].mean(dim=-1)
    return xp.tanh(0.7 * xin + xp.sin(c_noise)[:, None, None, None]) + v[:, None, None, None]


@pytest.mark.parametrize("step,pd", list(itertools.product([0, 2500, 10000], [False, True])))
def test_standard_diffusion_loss_matches_jax(step, pd):
    """loss_from_cond at the start, middle and end of the focal schedule,
    with and without the PD class weights and offset noise. The port gets
    the draws JAX makes from its key (loss.py:118-131)."""
    cfg = _loss_config(pd)
    jloss, tloss = j_instantiate(cfg), instantiate_from_config(cfg)
    jden = j_instantiate(load_config(TINY_CONFIG)["model"]["params"]["denoiser_config"])
    tden = instantiate_from_config(
        load_config(TINY_CONFIG)["model"]["params"]["denoiser_config"])
    x, jpg, cond = _loss_inputs()
    bt = x.shape[0]
    batch = {"jpg": jpg, "num_video_frames": LOSS_T,
             "image_only_indicator": np.zeros((LOSS_B, LOSS_T), np.float32)}
    key = jax.random.PRNGKey(7)

    def jnet(xin, c_noise, c, image_only_indicator=None, num_video_frames=None):
        assert image_only_indicator is not None and num_video_frames == LOSS_T
        return _toy_network(xin, c_noise, c, jnp)

    ref = np.asarray(jloss.loss_from_cond(
        key, jnet, jden, {k: jnp.asarray(v) for k, v in cond.items()}, jnp.asarray(x),
        {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in batch.items()},
        step))
    k_sigma, k_noise, k_offset = jax.random.split(key, 3)
    draws = {"sigma_rand": jax.random.normal(k_sigma, (bt,), jnp.float32),
             "noise": jax.random.normal(k_noise, x.shape, jnp.float32),
             "offset": jax.random.normal(k_offset, (bt, 4), jnp.float32)}
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}

    def tnet(xin, c_noise, c, image_only_indicator=None, num_video_frames=None):
        assert image_only_indicator is not None and num_video_frames == LOSS_T
        return _toy_network(xin, c_noise, c, torch)

    out = tloss.loss_from_cond(tnet, tden, {k: _t(v) for k, v in cond.items()}, _t(x),
                               {k: (_t(v) if isinstance(v, np.ndarray) else v)
                                for k, v in batch.items()}, step, draws=draws)
    assert out.shape == (bt,) and out.dtype == torch.float32
    assert rel_l2(out.numpy(), ref) <= TOL


def test_focal_fraction_and_pd_masks_are_live():
    """The cases above exercise what they claim: the focal fraction runs
    1 -> 0.55 -> 0.1 over the schedule, and the PD weights change the loss."""
    loss = instantiate_from_config(_loss_config(True))
    assert [float(loss._focal_fraction(s)) for s in (0, 2500, 10000)] == pytest.approx(
        [1.0, 0.55, 0.1])
    x, jpg, _ = _loss_inputs()
    w = torch.ones(x.shape[0])
    out = _t(x) + 0.1
    batch = {"jpg": _t(jpg)}
    plain = instantiate_from_config(_loss_config(False))
    assert not torch.allclose(loss.get_loss(out, _t(x), w, batch, 0),
                              plain.get_loss(out, _t(x), w, batch, 0))


@pytest.mark.parametrize("hw,out_hw", [((36, 52), (4, 6)), ((30, 40), (4, 5)),
                                       ((17, 24), (3, 3))])
def test_area_downsample_fallback_matches_jax_resize(hw, out_hw):
    """Where the grid does not divide, _area_downsample is
    jax.image.resize(..., "linear") with its antialiasing, within 1e-6."""
    mask = np.random.default_rng(sum(hw)).uniform(size=(2, *hw, 1)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(mask), (2, *out_hw, 1), method="linear"))
    out = _area_downsample(torch.from_numpy(mask), out_hw).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The sampled first stage, the conditioning dropout, remat, the optimizer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_jax_engine():
    cfg = load_config(TINY_CONFIG)["model"]
    jeng = j_instantiate(cfg)
    batch = tiny_batch(3, 32, 48, 9)
    return jeng, engine_params(jeng, batch, 40), batch


def test_encode_first_stage_samples_the_posterior_like_jax(tiny_jax_engine):
    """The repaired fault: encode_first_stage samples the posterior, and
    with JAX's noise -- normal(fold_in(key, chunk)) per chunk of 2 frames
    (engine.py:305-311) -- gives JAX's latents."""
    jeng, params, batch = tiny_jax_engine
    frames = batch["cond_frames"]
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax.jit(lambda p, x: jeng.encode_first_stage(p, x, key))(
        params, jnp.asarray(frames)))
    noise = np.concatenate([np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                                         (n, 4, 6, 4), jnp.float32))
                            for i, n in enumerate((2, 1))])
    emb_models = load_config(TINY_CONFIG)["model"]["params"]["conditioner_config"][
        "params"]["emb_models"]
    engine = load_engine(TINY_CONFIG, device="cpu", dtype=torch.float32,
                         state_dict=engine_state_dict(params, emb_models, 41))
    with torch.no_grad():
        out = engine.encode_first_stage(_t(frames), noise=_t(noise)).numpy()
        mode = engine.encode_first_stage(_t(frames), noise=torch.zeros(noise.shape)).numpy()
    assert rel_l2(out, ref) <= 1e-4  # a dozen conv layers in fp32, summed in another order
    assert rel_l2(mode, ref) > 1e-2  # the sample is not the mode


def test_conditioning_dropout(tiny_jax_engine):
    """ucg_rate 1.0 in JAX zeroes every frame of the CLIP and frame-encoder
    embeddings (flax's make_rng draws cannot be handed across); the port
    with the same weights and all-zero keep masks gives the same cond, and a
    partial mask zeroes exactly its frames. Frozen embedders run without
    grad; the trainable camera embedder keeps its graph. Masks drawn from a
    generator are reproducible and zero whole frames."""
    jeng, params, batch = tiny_jax_engine
    cfg = load_config(TINY_CONFIG)["model"]
    emb_models = cfg["params"]["conditioner_config"]["params"]["emb_models"]
    for i in (0, 3):
        emb_models[i]["ucg_rate"] = 1.0
    jcond = j_instantiate(cfg["params"]["conditioner_config"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = jcond.apply({"params": params["conditioner"]}, jbatch, None, True,
                      rngs={"ucg": jax.random.PRNGKey(0)})
    assert not np.asarray(ref["crossattn"]).any() and not np.asarray(ref["concat"]).any()

    engine = load_engine(TINY_CONFIG, device="cpu", dtype=torch.float32,
                         state_dict=engine_state_dict(params, emb_models, 41))
    tbatch = {k: _t(v) for k, v in batch.items()}
    out = engine.apply_conditioner(tbatch, train=True,
                                   ucg_keep={0: torch.zeros(3), 3: torch.zeros(3)})
    for name in ("vector", "crossattn", "concat"):
        np.testing.assert_allclose(out[name].detach().numpy(), np.asarray(ref[name]),
                                   rtol=TOL, atol=1e-6)
    assert out["vector"].requires_grad and not out["crossattn"].requires_grad
    assert not out["concat"].requires_grad

    with torch.no_grad():
        full = engine.apply_conditioner(tbatch)
        part = engine.apply_conditioner(tbatch, train=True,
                                        ucg_keep={0: torch.tensor([1.0, 0.0, 1.0]),
                                                  3: torch.tensor([0.0, 1.0, 1.0])})
        drawn = [engine.apply_conditioner(tbatch, train=True,
                                          generator=torch.Generator().manual_seed(3))
                 for _ in range(2)]
    torch.testing.assert_close(part["vector"], full["vector"], rtol=0, atol=0)
    for name, kept in (("crossattn", [0, 2]), ("concat", [1, 2])):
        dropped = sorted(set(range(3)) - set(kept))
        torch.testing.assert_close(part[name][kept], full[name][kept], rtol=0, atol=0)
        assert not part[name][dropped].any() and full[name][dropped].any()
        torch.testing.assert_close(drawn[0][name], drawn[1][name], rtol=0, atol=0)
        for frame, whole in zip(drawn[0][name], full[name]):
            assert not frame.any() or torch.equal(frame, whole)


def test_remat_recompute_takes_the_forward_kernel_switches():
    """With use_checkpoint the UNet's blocks run again in the backward; that
    recompute re-enters the switches the forward saw (a CUDA backward runs on
    another thread, where they are not set). Here the backward runs outside
    the forward's kernel_flags block, and a GroupNorm hook records what the
    recompute sees. Outputs and gradients equal the unrematerialised UNet's."""
    rng = np.random.default_rng(6)
    t = 3
    x = _t(rng.normal(size=(t, 8, 8, 8)).astype(np.float32)).permute(0, 3, 1, 2)
    ts, ctx = _t(rng.normal(size=(t,)).astype(np.float32)), _t(
        rng.normal(size=(t, 1, 24)).astype(np.float32))
    y = _t(rng.normal(size=(t, 26)).astype(np.float32))
    torch.manual_seed(0)
    plain = VideoUNet(**TINY_UNET)
    remat = VideoUNet(**TINY_UNET, use_checkpoint=True)
    remat.load_state_dict(plain.state_dict())
    seen = []
    norm = next(m for m in remat.input_blocks[1].modules() if isinstance(m, GroupNorm32))
    norm.register_forward_hook(lambda *_: seen.append(kernel_enabled("fused_gn")))
    outs, grads = [], []
    for net in (plain, remat):
        with kernel_flags(fused_gn=False):
            out = net(x, ts, ctx, y, num_video_frames=t)
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append(torch.cat([p.grad.flatten() for p in net.parameters()
                                if p.grad is not None]))
    assert seen == [False, False]  # forward, then the recompute
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=0)


def test_optimizer_from_config_follows_the_jax_mapping():
    p = [torch.nn.Parameter(torch.zeros(3))]
    adam = optimizer_from_config({"target": "torch.optim.Adam", "params": {"lr": 1.0}}, p, 2e-5)
    assert isinstance(adam, torch.optim.Adam) and adam.defaults["lr"] == 2e-5
    assert adam.defaults["weight_decay"] == 0.0
    adamw = optimizer_from_config(None, p, 1e-4)
    assert isinstance(adamw, torch.optim.AdamW) and adamw.defaults["weight_decay"] == 0.01
    sgd = optimizer_from_config({"target": "torch.optim.SGD", "params": {"momentum": 0.9}},
                                p, 0.1)
    assert isinstance(sgd, torch.optim.SGD) and sgd.defaults["momentum"] == 0.9
    with pytest.raises(ValueError, match="unsupported optimizer params"):
        optimizer_from_config({"target": "torch.optim.Adam", "params": {"amsgrad": True}},
                              p, 1e-4)
    with pytest.raises(ValueError, match="momentum"):
        optimizer_from_config({"target": "torch.optim.Adam", "params": {"momentum": 0.9}},
                              p, 1e-4)


def test_load_trainer_runs_on_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_trainer(TINY_CONFIG)
    trainer = load_trainer(TINY_CONFIG, device="cpu", dtype=torch.float32)
    assert {p.device.type for p in trainer.engine.parameters()} == {"cpu"}
    assert trainer.optimizer.defaults["lr"] == 1e-4  # the config's base_learning_rate
    assert all(m.dtype == torch.float32 for m in trainer.masters)

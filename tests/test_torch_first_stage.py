"""The first-stage family of the port against the JAX package on the CPU:
VideoAttnBlock, the VideoDecoder's attn-only / all time modes,
AutoencoderKL, AutoencodingEngineLegacy, an AutoencodingEngine with a VQ
regularizer, IdentityFirstStage through the tiny engine, the four
quantizers, NLayerDiscriminator and GeneralLPIPSWithDiscriminator. Inputs
and random numbers come from numpy seeds or from the JAX keys the JAX
modules draw with (the port takes those draws as tensors); weights are
seeded flax trees carried across by gcd_tpu_torch/io/convert.py and loaded
with strict=True.

Tolerances, fp32 on both sides (JAX at highest matmul precision): 1e-5
relative L2 for a single block, a quantizer or the discriminator (sums in
another order, ~1e-7); 1e-4 for whole decoders and autoencoders, which
chain dozens of layers (the bound tests/test_torch_slice.py holds the
conv-only decoder to); indices exact.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.models import discriminator as jdisc
from gcd_tpu.models import vae as jvae
from gcd_tpu.models import vq as jvq
from gcd_tpu.models.lpips import LPIPS as JLPIPS
from gcd_tpu.utils.config import instantiate_from_config as j_instantiate
from gcd_tpu_torch.engine.build import engine_from_config
from gcd_tpu_torch.io.convert import (
    discriminator_loss_state_dict_from_flax,
    discriminator_state_dict_from_flax,
    first_stage_state_dict_from_flax,
    lpips_state_dict_from_flax,
    quantizer_state_dict_from_flax,
)
from gcd_tpu_torch.models import discriminator as pdisc
from gcd_tpu_torch.models import vae as pvae
from gcd_tpu_torch.models import vq as pvq
from gcd_tpu_torch.utils.config import REGISTRY, instantiate_from_config, load_config
from tests.torch_port_helpers import (
    TINY_CONFIG,
    TINY_DD,
    fill_params,
    flax_params,
    load_port,
    nchw,
    nhwc,
    rel_l2,
    tiny_batch,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

BLOCK_TOL = 1e-5
MODEL_TOL = 1e-4
F32 = np.float32


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(F32)


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, F32)).requires_grad_(grad)


def _close(got, want, tol=BLOCK_TOL) -> bool:
    """Two scalars within `tol` relative."""
    got, want = float(torch.as_tensor(got).detach()), float(want)
    return abs(got - want) <= tol * abs(want)


def test_the_ten_names_resolve():
    names = ["sgm.models.autoencoder." + n for n in
             ("AutoencodingEngineLegacy", "AutoencoderKL", "IdentityFirstStage")]
    names += ["sgm.modules.autoencoding.regularizers.quantize." + n for n in
              ("VectorQuantizer", "VectorQuantizerWithInputProjection", "GumbelQuantizer",
               "EMAVectorQuantizer")]
    names += ["sgm.modules.autoencoding.lpips.model.model.NLayerDiscriminator",
              "sgm.modules.autoencoding.losses.discriminator_loss.GeneralLPIPSWithDiscriminator",
              "sgm.modules.autoencoding.losses.GeneralLPIPSWithDiscriminator"]
    assert all(n in REGISTRY for n in names)
    vq = instantiate_from_config({"target": names[3], "params": {"n_e": 8, "e_dim": 4}})
    loss = instantiate_from_config({"target": names[-1], "params": {"disc_start": 5000}})
    assert isinstance(vq, pvq.VectorQuantizer)
    assert isinstance(loss, pdisc.GeneralLPIPSWithDiscriminator)
    assert isinstance(instantiate_from_config({"target": names[2]}), pvae.IdentityFirstStage)


# --------------------------------------------------------------------------
# VideoAttnBlock and the VideoDecoder's time modes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("merge", ["learned", "fixed"])
def test_video_attn_block_matches_jax(merge):
    """One head of width 64 over 4 x 4 positions, 2 videos of 3 frames."""
    t, c = 3, 64
    x = _normal(1, (2 * t, 4, 4, c))
    jblk = jvae.VideoAttnBlock(alpha=0.3, merge_strategy=merge)
    params = flax_params(jblk, 2, jnp.asarray(x), timesteps=t)
    want = np.asarray(jax.jit(lambda p, x: jblk.apply({"params": p}, x, timesteps=t))(
        params, jnp.asarray(x)))
    port = load_port(pvae.VideoAttnBlock(c, 0.3, merge), params)
    assert hasattr(port, "mix_factor") == (merge == "learned")
    with torch.no_grad():
        got = port(nchw(x), t)
    assert np.abs(want - x).max() > 1e-2  # the block is no identity
    assert rel_l2(nhwc(got), want) <= BLOCK_TOL


# attn_resolutions (8, 16) puts VideoAttnBlocks at both up levels (widths 64
# and 32) beside the mid block's (width 64).
@pytest.mark.parametrize("attn_res", [(), (8, 16)])
@pytest.mark.parametrize("mode", ["attn-only", "all"])
def test_video_decoder_time_modes_match_jax(mode, attn_res):
    dd = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=list(attn_res),
              z_channels=4, resolution=16, out_ch=3, video_kernel_size=[3, 1, 1],
              time_mode=mode)
    z = _normal(3, (4, 8, 8, 4))
    jdec = jvae.VideoDecoder(**dd)
    params = flax_params(jdec, 4, jnp.asarray(z), timesteps=2)
    want = np.asarray(jax.jit(lambda p, z: jdec.apply({"params": p}, z, timesteps=2))(
        params, jnp.asarray(z)))
    port = load_port(pvae.VideoDecoder(**dd), params)
    blocks = [type(m).__name__ for m in port.modules()]
    assert blocks.count("VideoAttnBlock") == 1 + 2 * len(attn_res)
    assert ("DecoderVideoResBlock" in blocks) == (mode == "all")
    with torch.no_grad():
        got = port(nchw(z), 2)
    assert got.shape == (4, 3, 16, 16)
    assert rel_l2(nhwc(got), want) <= MODEL_TOL


def test_video_decoder_refuses_an_unknown_time_mode():
    with pytest.raises(ValueError, match="time_mode"):
        pvae.VideoDecoder(ch=32, ch_mult=[1, 2], time_mode="attn")


# --------------------------------------------------------------------------
# First-stage engines
# --------------------------------------------------------------------------

DD16 = dict(TINY_DD, attn_resolutions=[8])


def _engine_params(jeng, seed, hw=(16, 16)):
    shapes = jax.eval_shape(lambda: jeng.init(jax.random.PRNGKey(0), img_hw=hw, t=1))
    return fill_params(shapes, seed)


@pytest.mark.parametrize("target,sample", [("AutoencoderKL", True),
                                           ("AutoencodingEngineLegacy", False)])
def test_legacy_engines_match_jax(target, sample):
    """encode (the posterior sampled with the noise JAX draws from its key,
    or its mode) and decode; embed_dim 3 against z_channels 4, so the quant
    convs change the width."""
    cfg = {"target": f"sgm.models.autoencoder.{target}",
           "params": {"embed_dim": 3, "ddconfig": DD16}}
    if not sample:
        cfg["params"]["regularizer_config"] = {
            "target": "sgm.modules.autoencoding.regularizers.DiagonalGaussianRegularizer",
            "params": {"sample": False}}
    jeng = j_instantiate(copy.deepcopy(cfg))
    params = _engine_params(jeng, 5)
    x = np.random.default_rng(6).uniform(-1, 1, (2, 16, 16, 3)).astype(F32)
    key = jax.random.PRNGKey(7)
    z_want = np.asarray(jax.jit(lambda p, x: jeng.encode(p, x, key=key))(params, x))
    rec_want = np.asarray(jax.jit(lambda p, z: jeng.decode(p, z))(params, z_want))
    port = instantiate_from_config(copy.deepcopy(cfg))
    port.load_state_dict(first_stage_state_dict_from_flax(params, ""), strict=True)
    assert port.latent_channels == 3
    noise = np.asarray(jax.random.normal(key, z_want.shape)) if sample else None
    with torch.no_grad():
        z = port.encode(nchw(x), None if noise is None else nchw(noise))
        rec = port.decode(nchw(z_want))
    assert rel_l2(nhwc(z), z_want) <= MODEL_TOL
    assert rel_l2(nhwc(rec), rec_want) <= MODEL_TOL


def test_vq_regularized_engine_matches_jax():
    """An AutoencodingEngine with a VectorQuantizer regularizer (the JAX
    package's tests/test_vq_discriminator.py engine): z_q and the decode."""
    dd = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], in_channels=3,
              out_ch=3, resolution=16, z_channels=4, double_z=False)
    cfg = {"target": "sgm.models.autoencoder.AutoencodingEngine", "params": {
        "encoder_config": {"target": "sgm.modules.diffusionmodules.model.Encoder",
                           "params": dd},
        "decoder_config": {"target": "sgm.modules.diffusionmodules.model.Decoder",
                           "params": dd},
        "regularizer_config": {
            "target": "sgm.modules.autoencoding.regularizers.quantize.VectorQuantizer",
            "params": {"n_e": 16, "e_dim": 4}}}}
    jeng = j_instantiate(copy.deepcopy(cfg))
    params = _engine_params(jeng, 8)
    x = np.random.default_rng(9).uniform(-1, 1, (2, 16, 16, 3)).astype(F32)
    z_want = np.asarray(jax.jit(jeng.encode)(params, x))
    rec_want = np.asarray(jax.jit(jeng.decode)(params, z_want))
    port = instantiate_from_config(copy.deepcopy(cfg))
    port.load_state_dict(first_stage_state_dict_from_flax(params, ""), strict=True)
    with torch.no_grad():
        z = port.encode(nchw(x))
        rec = port.decode(nchw(z_want))
    assert rel_l2(nhwc(z), z_want) <= BLOCK_TOL
    assert rel_l2(nhwc(rec), rec_want) <= MODEL_TOL


def test_identity_first_stage_through_the_tiny_engine():
    """The tiny engine with IdentityFirstStage: its encode / decode
    (scale_factor only) against the JAX engine's, and sample_video, whose
    frames are then the sampled latents / scale_factor in [0, 1]. The
    sampling itself is held against JAX by tests/test_torch_slice.py."""
    cfg = copy.deepcopy(load_config(TINY_CONFIG)["model"])
    cfg["params"]["first_stage_config"] = {"target": "sgm.models.autoencoder.IdentityFirstStage"}
    cfg["params"]["sampler_config"]["params"]["num_steps"] = 2
    engine = engine_from_config(cfg, device="cpu", dtype=torch.float32)
    jcfg = copy.deepcopy(cfg)
    jcfg["params"].pop("conditioner_config")
    jeng = j_instantiate(jcfg)
    sf = engine.scale_factor
    z = _normal(10, (3, 4, 4, 4))
    with torch.no_grad():
        dec = engine.decode_first_stage(nchw(z), 3)
        enc = engine.encode_first_stage(torch.from_numpy(z))
    np.testing.assert_array_equal(nhwc(dec), np.asarray(jeng.decode_first_stage({"first_stage": {}}, z, 3)))
    np.testing.assert_array_equal(enc.numpy(), np.asarray(jeng.encode_first_stage({"first_stage": {}}, z)))
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch(3, 32, 32, 11).items()}
    out = engine.sample_video(batch, noise=torch.from_numpy(_normal(12, (3, 4, 4, 4))),
                              return_latents=True)
    assert out["sampled_video"].shape == (3, 4, 4, 4)
    want = ((out["sampled_z"] / sf + 1.0) / 2.0).clamp(0.0, 1.0)
    torch.testing.assert_close(out["sampled_video"], want, rtol=0, atol=0)


# --------------------------------------------------------------------------
# Quantizers
# --------------------------------------------------------------------------


def _grads_jax(fn, *args):
    return [np.asarray(g) for g in jax.grad(fn, argnums=tuple(range(len(args))))(*args)]


@pytest.mark.parametrize("remap", [None, 0, "random"])
def test_vector_quantizer_matches_jax(remap, tmp_path):
    """Indices (exact), z_q, the loss with JAX's beta placement, perplexity,
    the straight-through gradient and the codebook's gradient; with a remap
    to 8 of the 16 codes, unknown codes to 0 or to JAX's random draws."""
    n_e, e_dim = 16, 8
    z = _normal(13, (2, 4, 4, e_dim))
    emb = _normal(14, (n_e, e_dim))
    r = _normal(15, z.shape)
    kwargs = dict(beta=0.25, sane_index_shape=True, log_perplexity=True)
    draws = None
    if remap is not None:
        path = str(tmp_path / "used.npy")
        np.save(path, np.array([0, 2, 4, 6, 8, 10, 13, 15]))
        kwargs.update(remap=path, unknown_index=remap)
    key = jax.random.PRNGKey(16)
    jmod = jvq.VectorQuantizer(n_e, e_dim, **kwargs)

    def jfwd(e, zz):
        return jmod.apply({"params": {"embedding": e}}, zz, key=key)

    zq_w, ld_w = jfwd(jnp.asarray(emb), jnp.asarray(z))
    g_emb, g_z = _grads_jax(lambda e, zz: jnp.sum(jfwd(e, zz)[0] * r) + jfwd(e, zz)[1]["loss/vq"],
                            jnp.asarray(emb), jnp.asarray(z))
    if remap == "random":
        draws = torch.from_numpy(np.array(jax.random.randint(key, (2, 16), 0, 8)))
    port = pvq.VectorQuantizer(n_e, e_dim, **kwargs)
    port.load_state_dict(quantizer_state_dict_from_flax({"params": {"embedding": emb}}),
                         strict=True)
    zt = _t(z, grad=True)
    zq, ld = port(zt, random_index=draws)
    ((zq * _t(r)).sum() + ld["loss/vq"]).backward()
    np.testing.assert_array_equal(ld["min_encoding_indices"].numpy(),
                                  np.asarray(ld_w["min_encoding_indices"]))
    assert rel_l2(zq.detach().numpy(), np.asarray(zq_w)) <= BLOCK_TOL
    for k in ("loss/vq", "perplexity"):
        assert _close(ld[k], ld_w[k])
    assert int(ld["cluster_usage"]) == int(ld_w["cluster_usage"])
    assert rel_l2(zt.grad.numpy(), g_z) <= BLOCK_TOL
    assert rel_l2(port.embedding.weight.grad.numpy(), g_emb) <= BLOCK_TOL
    if remap is None:
        idx = ld["min_encoding_indices"].reshape(-1)
        want = jmod.get_codebook_entry({"params": {"embedding": emb}}, jnp.asarray(idx.numpy()),
                                       shape=z.shape)
        np.testing.assert_array_equal(
            port.get_codebook_entry(idx, z.shape).detach().numpy(), np.asarray(want))


def test_vq_with_input_projection_matches_jax():
    jmod = jvq.VectorQuantizerWithInputProjection(input_dim=8, n_codes=16, codebook_dim=4,
                                                  output_dim=8)
    z = _normal(17, (2, 4, 4, 8))
    params = flax_params(jmod, 18, jnp.asarray(z))
    zq_w, ld_w = jmod.apply({"params": params}, jnp.asarray(z))
    port = pvq.VectorQuantizerWithInputProjection(8, 16, 4, output_dim=8)
    port.load_state_dict(quantizer_state_dict_from_flax({"params": params}), strict=True)
    with torch.no_grad():
        zq, ld = port(_t(z))
    assert zq.shape == z.shape
    np.testing.assert_array_equal(ld["min_encoding_indices"].numpy(),
                                  np.asarray(ld_w["min_encoding_indices"]))
    assert rel_l2(zq.numpy(), np.asarray(zq_w)) <= BLOCK_TOL
    assert _close(ld["loss/vq"], ld_w["loss/vq"])


@pytest.mark.parametrize("training", [True, False])
def test_gumbel_quantizer_matches_jax(training):
    """Training: the Gumbel noise JAX draws from its key, passed in; hard
    straight-through one-hots and their gradient. Evaluation: no noise."""
    jmod = jvq.GumbelQuantizer(num_hiddens=8, embedding_dim=6, n_embed=16, temp_init=0.7)
    z = _normal(19, (2, 4, 4, 8))
    r = _normal(20, (2, 4, 4, 6))
    params = flax_params(jmod, 21, jnp.asarray(z))
    key = jax.random.PRNGKey(22) if training else None

    def jfwd(p, zz):
        return jmod.apply({"params": p}, zz, key=key, training=training)

    zq_w, ld_w = jfwd(params, jnp.asarray(z))
    (g_z,) = _grads_jax(lambda zz: jnp.sum(jfwd(params, zz)[0] * r) + jfwd(params, zz)[1]["loss/vq"],
                        jnp.asarray(z))
    port = pvq.GumbelQuantizer(8, 6, 16, temp_init=0.7)
    port.load_state_dict(quantizer_state_dict_from_flax({"params": params}), strict=True)
    port.train(training)
    gumbel = (torch.from_numpy(np.array(jax.random.gumbel(key, (2, 4, 4, 16), jnp.float32)))
              if training else None)
    zt = _t(z, grad=True)
    zq, ld = port(zt, gumbel=gumbel)
    ((zq * _t(r)).sum() + ld["loss/vq"]).backward()
    np.testing.assert_array_equal(ld["indices"].numpy(), np.asarray(ld_w["indices"]))
    assert rel_l2(zq.detach().numpy(), np.asarray(zq_w)) <= BLOCK_TOL
    assert _close(ld["loss/vq"], ld_w["loss/vq"])
    assert rel_l2(zt.grad.numpy(), g_z) <= BLOCK_TOL


def test_ema_vector_quantizer_update_matches_jax():
    """One training-mode call: z_q, the loss, indices, perplexity and the
    three EMA buffers after the update; then an evaluation call leaves
    them."""
    jmod = jvq.EMAVectorQuantizer(n_embed=8, embedding_dim=4, beta=0.25, decay=0.5)
    z = _normal(23, (2, 4, 4, 4))
    w = _normal(24, (8, 4))
    ema = {"weight": w, "cluster_size": np.abs(_normal(25, (8,))), "embed_avg": w * 1.5}
    (zq_w, ld_w), upd = jmod.apply({"ema": ema}, jnp.asarray(z), training=True,
                                   mutable=["ema"])
    port = pvq.EMAVectorQuantizer(8, 4, 0.25, decay=0.5)
    port.load_state_dict(quantizer_state_dict_from_flax({"ema": ema}), strict=True)
    port.train()
    zq, ld = port(_t(z))
    np.testing.assert_array_equal(ld["encoding_indices"].numpy(),
                                  np.asarray(ld_w["encoding_indices"]))
    assert rel_l2(zq.detach().numpy(), np.asarray(zq_w)) <= BLOCK_TOL
    for k in ("loss/vq", "perplexity"):
        assert _close(ld[k], ld_w[k])
    for name in ("weight", "cluster_size", "embed_avg"):
        assert rel_l2(getattr(port.embedding, name).numpy(),
                      np.asarray(upd["ema"][name])) <= BLOCK_TOL
    before = port.embedding.weight.clone()
    port.eval()
    port(_t(z))
    assert torch.equal(port.embedding.weight, before)


# --------------------------------------------------------------------------
# Discriminator and the LPIPS + GAN loss
# --------------------------------------------------------------------------


def _disc_variables(shapes, seed):
    """Seeded params, and running statistics with positive variances."""
    rng = np.random.default_rng(seed + 1)
    out = {"params": fill_params(shapes["params"], seed)}
    if "batch_stats" in shapes:
        out["batch_stats"] = {
            name: {"mean": (0.1 * rng.normal(size=s["mean"].shape)).astype(F32),
                   "var": rng.uniform(0.5, 1.5, s["var"].shape).astype(F32)}
            for name, s in shapes["batch_stats"].items()}
    return out


@pytest.mark.parametrize("actnorm", [False, True])
def test_nlayer_discriminator_matches_jax(actnorm):
    """Patch logits on running statistics, then one training-mode pass:
    logits on batch statistics and the running mean and (biased) variance
    flax folds in, which torch's BatchNorm2d would not give."""
    jd = jdisc.NLayerDiscriminator(ndf=8, n_layers=3, use_actnorm=actnorm)
    x = _normal(26, (2, 32, 32, 3)) + 0.5
    shapes = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), jnp.zeros(x.shape),
                                            training=False))
    variables = _disc_variables(shapes, 27)
    eval_w = np.asarray(jd.apply(variables, jnp.asarray(x), training=False))
    train_w, mut = jd.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
    port = pdisc.NLayerDiscriminator(3, 8, 3, use_actnorm=actnorm)
    port.load_state_dict(discriminator_state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got_eval = port.eval()(nchw(x))
        got_train = port.train()(nchw(x))
    assert got_eval.shape == (2, 1, 2, 2)
    assert rel_l2(nhwc(got_eval), eval_w) <= BLOCK_TOL
    assert rel_l2(nhwc(got_train), np.asarray(train_w)) <= BLOCK_TOL
    moved = discriminator_state_dict_from_flax({"params": variables["params"], **mut})
    state = port.state_dict()
    for k, v in moved.items():
        if k.endswith(("running_mean", "running_var")):
            assert rel_l2(state[k].numpy(), v.numpy()) <= BLOCK_TOL, k
    assert not actnorm or not mut.get("batch_stats")


def test_lpips_discriminator_loss_matches_jax():
    """Both phases in training mode, the GAN terms active (step 10 >=
    disc_start 5), LPIPS on, a regularization term: the adaptive weight
    from both frameworks' gradients at a last layer (the discriminator on
    running statistics), each phase's loss, log and gradient (at the
    reconstructions, and at the discriminator's weights), and the running
    statistics the phases leave."""
    jl = jdisc.GeneralLPIPSWithDiscriminator(disc_start=5, logvar_init=0.3, disc_num_layers=2,
                                             regularization_weights={"kl_loss": 1e-2})
    shapes = jax.eval_shape(lambda: jl.discriminator.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), training=False))
    variables = {**_disc_variables(shapes, 28), "logvar": np.asarray(0.3, F32)}
    lp_shapes = jax.eval_shape(lambda: JLPIPS().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 16, 16, 3))))
    lp_vars = fill_params(lp_shapes, 29)
    x = np.random.default_rng(30).uniform(-1, 1, (2, 16, 16, 3)).astype(F32)
    feat = _normal(31, (2, 16, 16, 4))
    last = _normal(32, (4, 3), 0.5)
    reg = {"kl_loss": np.asarray(0.7, F32)}

    def rec_of(w):
        return jnp.einsum("nhwc,cd->nhwd", feat, w)

    def nll_of(w):
        return jl.get_nll_loss(variables["logvar"], jnp.abs(x - rec_of(w)))[0]

    def g_of(w):
        return -jnp.mean(jl.discriminator.apply(
            {k: variables[k] for k in ("params", "batch_stats")}, rec_of(w), training=False))

    jw = jnp.asarray(last)
    d_weight_w = jdisc.adaptive_weight_from_grads(jax.grad(nll_of)(jw), jax.grad(g_of)(jw),
                                                  discriminator_weight=0.8)
    rec = np.asarray(rec_of(jw))

    def phase(p, r, idx, **kw):
        return jl({**variables, "params": p}, x, r, optimizer_idx=idx, global_step=10,
                  lpips_params=lp_vars, training=True, **kw)

    gen = jax.jit(lambda p, r: phase(p, r, 0, regularization_log=reg, d_weight=d_weight_w))
    dis = jax.jit(lambda p, r: phase(p, r, 1))
    g_loss_w, g_log_w, g_vars_w = gen(variables["params"], rec)
    g_grad_w = np.asarray(jax.grad(lambda r: gen(variables["params"], r)[0])(rec))
    d_loss_w, d_log_w, d_vars_w = dis(variables["params"], rec)
    d_grad_w = jax.grad(lambda p: dis(p, rec)[0])(variables["params"])

    def port_loss():
        loss = pdisc.GeneralLPIPSWithDiscriminator(disc_start=5, logvar_init=0.3,
                                                   disc_num_layers=2,
                                                   regularization_weights={"kl_loss": 1e-2})
        loss.load_state_dict(discriminator_loss_state_dict_from_flax(variables), strict=True)
        return loss

    lp_sd = lpips_state_dict_from_flax(lp_vars["params"])
    ploss = port_loss().eval()
    pw = _t(last, grad=True)
    prec = torch.einsum("nhwc,cd->nhwd", _t(feat), pw).permute(0, 3, 1, 2)
    nll, _ = ploss.get_nll_loss((nchw(x) - prec).abs())
    g = -ploss.discriminator(prec).mean()
    d_weight = pdisc.adaptive_weight_from_grads(
        torch.autograd.grad(nll, pw, retain_graph=True), {"w": torch.autograd.grad(g, pw)[0]},
        discriminator_weight=0.8)
    assert _close(d_weight, d_weight_w)

    ploss.train()
    prec = nchw(rec).requires_grad_(True)
    g_loss, g_log = ploss(nchw(x), prec, optimizer_idx=0, global_step=10,
                          regularization_log={"kl_loss": _t(reg["kl_loss"])},
                          d_weight=d_weight, lpips_params=lp_sd)
    g_loss.backward()
    assert _close(g_loss, g_loss_w)
    assert set(g_log) == set(g_log_w)
    for k in g_log:
        assert _close(g_log[k], g_log_w[k]), k
    assert rel_l2(nhwc(prec.grad), g_grad_w) <= BLOCK_TOL
    _assert_stats(ploss, g_vars_w)

    ploss = port_loss().train()
    d_loss, d_log = ploss(nchw(x), nchw(rec), optimizer_idx=1, global_step=10,
                          lpips_params=lp_sd)
    d_loss.backward()
    assert _close(d_loss, d_loss_w)
    for k in d_log:
        assert _close(d_log[k], d_log_w[k]), k
    want = discriminator_state_dict_from_flax({"params": d_grad_w}, "discriminator.")
    for k, v in want.items():
        assert rel_l2(ploss.state_dict(keep_vars=True)[k].grad.numpy(), v.numpy()) <= BLOCK_TOL, k
    _assert_stats(ploss, d_vars_w)


def _assert_stats(ploss, variables_w):
    want = discriminator_state_dict_from_flax(
        {"params": {}, "batch_stats": variables_w["batch_stats"]}, "discriminator.")
    state = ploss.state_dict()
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            assert rel_l2(state[k].numpy(), v.numpy()) <= BLOCK_TOL, k

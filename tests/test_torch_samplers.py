"""The port's sgm sampling family (gcd_tpu_torch/diffusion/) against the JAX
package's (gcd_tpu/diffusion/), fp32 on the CPU.

The six samplers run on one toy denoiser written on each side (D(x, s, c) =
tanh(x / sqrt(1 + s^2)) * vector + concat), with JAX's own per-step noise
(normal(split(key, steps)[i], x.shape)) passed to the port, transposed to
its channels-first layout: relative L2 <= 1e-5 (the two sides differ in
the order of fp32 sums and in host float32 math against device float32
math, ~1e-7 a step). The ladders are bit-equal, DiscreteDenoiser's indices
equal and the scalings within 1e-6. The tiny engine's sample_video with an
ancestral and a Heun sampler is held at 1e-3 on the [0, 1] frames, as
tests/test_torch_slice.py holds Euler's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.utils.config import instantiate_from_config as j_instantiate
from gcd_tpu_torch.engine.build import engine_from_config
from gcd_tpu_torch.engine.export import export_sampler
from gcd_tpu_torch.utils.config import instantiate_from_config, load_config
from tests.torch_port_helpers import (
    TINY_CONFIG,
    engine_params,
    engine_state_dict,
    rel_l2,
    tiny_batch,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

T = 3
SAMPLING = "sgm.modules.diffusionmodules.sampling."
EDM_LADDER = {"target": "sgm.modules.diffusionmodules.discretizer.EDMDiscretization",
              "params": {"sigma_max": 700.0}}
DDPM_LADDER = {"target": "sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization"}
LPG = {"target": "sgm.modules.diffusionmodules.guiders.LinearPredictionGuider",
       "params": {"max_scale": 2.5, "min_scale": 1.0, "num_frames": T}}
# Churn only on the ladder's middle (sigma in [0.5, 60] of 700 ... 0.002).
SAMPLERS = {
    "EDMSampler": {"s_churn": 4.0, "s_tmin": 0.5, "s_tmax": 60.0},
    "HeunEDMSampler": {},
    "EulerAncestralSampler": {"eta": 0.8},
    "DPMPP2SAncestralSampler": {},
    "DPMPP2MSampler": {},
    "LinearMultistepSampler": {"order": 4},
}
STEPS = 8


def _config(name, guider=LPG, steps=STEPS, interval=None, ladder=EDM_LADDER):
    params = {"discretization_config": ladder, "num_steps": steps,
              "guidance_interval": interval, **SAMPLERS.get(name, {})}
    if guider is not None:
        params["guider_config"] = guider
    return {"target": SAMPLING + name, "params": copy.deepcopy(params)}


def _toy_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2 * T, 4, 4, 2)).astype(np.float32)
    c = {"vector": rng.normal(size=(2 * T, 2)).astype(np.float32),
         "concat": rng.normal(size=(2 * T, 4, 4, 2)).astype(np.float32)}
    uc = {"vector": c["vector"], "concat": np.zeros_like(c["concat"])}
    return x, c, uc


def _j_toy(xx, s, cc):
    return (jnp.tanh(xx / jnp.sqrt(1.0 + s ** 2)[:, None, None, None])
            * cc["vector"][:, None, None, :] + cc["concat"])


def _cf(a: np.ndarray) -> torch.Tensor:
    """NHWC (or a stack of NHWC) numpy -> channels-first torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _jax_step_noise(key, steps, shape):
    """JAX's per-step noise: row i is normal(split(key, steps)[i], shape)."""
    return np.stack([np.asarray(jax.random.normal(k, shape, dtype=jnp.float32))
                     for k in jax.random.split(key, steps)])


def _run_toy(cfg, seed=9, key=jax.random.PRNGKey(5)):
    """(port output NHWC, JAX output, the port's UNet batch sizes in
    order) on the toy denoiser."""
    x, c, uc = _toy_inputs(seed)
    jsampler = j_instantiate(copy.deepcopy(cfg))
    ref = np.asarray(jsampler(_j_toy, jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, c),
                              jax.tree_util.tree_map(jnp.asarray, uc), key=key))
    sampler = instantiate_from_config(copy.deepcopy(cfg))
    step_noise = None
    if sampler.needs_step_noise:
        step_noise = _cf(_jax_step_noise(key, len(sampler.sigmas()) - 1, x.shape))
    batches = []

    def denoiser(xx, s, cc):
        batches.append(xx.shape[0])
        return (torch.tanh(xx / torch.sqrt(1.0 + s ** 2)[:, None, None, None])
                * cc["vector"][:, :, None, None] + cc["concat"])

    out = sampler(denoiser, _cf(x), {k: _cf(v) if v.ndim == 4 else torch.from_numpy(v)
                                     for k, v in c.items()},
                  {k: _cf(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in uc.items()},
                  step_noise=step_noise)
    return out.permute(0, 2, 3, 1).numpy(), ref, batches, sampler


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_matches_jax(name):
    """Each sampler, LinearPredictionGuider up to 2.5, 8 steps of the EDM
    ladder to sigma_max 700. The evaluations: one a step, Heun's and DPM++
    2S's two but on the final step; EDMSampler churns the steps of sigma in
    [0.5, 60] only, the ancestral samplers add noise at every step but the
    last."""
    out, ref, batches, sampler = _run_toy(_config(name))
    evals = {"HeunEDMSampler": 2 * STEPS - 1, "DPMPP2SAncestralSampler": 2 * STEPS - 1}
    assert batches == [4 * T] * evals.get(name, STEPS)
    assert sampler.needs_step_noise == (name in ("EDMSampler", "EulerAncestralSampler",
                                                 "DPMPP2SAncestralSampler"))
    if name == "EDMSampler":
        churned = [p["bump"] > 0 for p in sampler.plan(sampler.sigmas())]
        assert 0 < sum(churned) < STEPS
    assert np.abs(ref).max() > 0.1
    assert rel_l2(out, ref) <= 1e-5


@pytest.mark.parametrize("name", ["HeunEDMSampler", "DPMPP2SAncestralSampler"])
def test_second_evaluation_guidance_interval(name):
    """A guidance_interval whose lower bound sits between a step's sigma
    and the sigma of its second evaluation (Heun: the next sigma; DPM++ 2S:
    exp(-s)): that step's first evaluation is guided, its second is not,
    on both sides."""
    sampler = instantiate_from_config(_config(name))
    sigmas = sampler.sigmas()
    step = 3
    second = sampler.plan(sigmas)[step]["evals"][1]
    assert second < sigmas[step]
    lo = float(np.sqrt(sigmas[step] * second))
    out, ref, batches, sampler = _run_toy(_config(name, interval=(lo, 1000.0)))
    guided = sampler.guided_evaluations()
    assert guided[step] == [True, False]
    assert batches == [4 * T if g else 2 * T for step_g in guided for g in step_g]
    assert rel_l2(out, ref) <= 1e-5


def _perfect_denoiser(x0):
    def denoiser(x, sigma, cond):
        return torch.full_like(x, x0)

    return denoiser


@pytest.mark.parametrize("name", ["EulerEDMSampler", *SAMPLERS])
def test_samplers_converge_with_perfect_denoiser(name):
    """tests/test_diffusion_core.py's case: with a delta data distribution
    at 3.5, the denoiser that returns 3.5 takes every sampler there (20
    steps to sigma_max 80, no guider: IdentityGuider)."""
    params = dict(SAMPLERS.get(name, {}))
    params.pop("s_churn", None)  # the JAX case runs the samplers' defaults
    sampler = instantiate_from_config({"target": SAMPLING + name, "params": {
        "num_steps": 20, "discretization_config": {
            "target": EDM_LADDER["target"], "params": {"sigma_max": 80.0}}, **params}})
    assert type(sampler.guider).__name__ == "IdentityGuider"
    gen = torch.Generator().manual_seed(0)
    noise = torch.randn(2, 1, 4, 4, generator=gen)
    step_noise = torch.randn(20, 2, 1, 4, 4, generator=gen)
    out = sampler(_perfect_denoiser(3.5), noise, {}, None, step_noise=step_noise)
    np.testing.assert_allclose(out.numpy(), 3.5, rtol=2e-2, atol=2e-2)


def test_guiders_match_jax():
    """IdentityGuider keeps the batch; VanillaCFG doubles it uc first and
    mixes uc + scale * (c - uc); both against JAX's."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2 * T, 2, 4, 4)).astype(np.float32)
    s = rng.uniform(1, 5, size=(2 * T,)).astype(np.float32)
    c = {"vector": rng.normal(size=(2 * T, 5)).astype(np.float32),
         "crossattn": rng.normal(size=(2 * T, 1, 3)).astype(np.float32),
         "extra": rng.normal(size=(2 * T, 2)).astype(np.float32)}
    uc = {k: v * 0.5 for k, v in c.items()}
    to_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    for target, params in (("IdentityGuider", {}), ("VanillaCFG", {"scale": 3.5})):
        cfg = {"target": "sgm.modules.diffusionmodules.guiders." + target, "params": params}
        jg, g = j_instantiate(cfg), instantiate_from_config(cfg)
        jx, js, jc = jg.prepare_inputs(jnp.asarray(x), jnp.asarray(s), to_j(c), to_j(uc))
        px, ps, pc = g.prepare_inputs(torch.from_numpy(x), torch.from_numpy(s), to_t(c), to_t(uc))
        np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        assert sorted(pc) == sorted(jc)
        for k in pc:
            np.testing.assert_array_equal(pc[k].numpy(), np.asarray(jc[k]))
        out = rng.normal(size=tuple(px.shape)).astype(np.float32)
        np.testing.assert_allclose(g(torch.from_numpy(out)).numpy(),
                                   np.asarray(jg(jnp.asarray(out), None)), rtol=1e-6, atol=1e-6)
    assert px.shape[0] == 4 * T  # VanillaCFG doubled


@pytest.mark.parametrize("n,append,flip", [(25, True, False), (1000, False, True),
                                           (7, False, False), (50, True, True)])
def test_ladders_match_jax(n, append, flip):
    """LegacyDDPMDiscretization's and EDMDiscretization's ladders equal
    JAX's bit for bit."""
    for cfg in (DDPM_LADDER, EDM_LADDER):
        np.testing.assert_array_equal(
            instantiate_from_config(cfg)(n, do_append_zero=append, flip=flip),
            j_instantiate(cfg)(n, do_append_zero=append, flip=flip))
    with pytest.raises(ValueError):
        instantiate_from_config(DDPM_LADDER)(1001)


SCALINGS = ["EDMScaling", "EpsScaling", "VScaling", "DumbScaling", "VScalingWithEDMcNoise"]


@pytest.mark.parametrize("scaling", SCALINGS)
def test_discrete_denoiser_matches_jax(scaling):
    """The scaling's (c_skip, c_out, c_in, c_noise) within 1e-6 of JAX's;
    DiscreteDenoiser over the 1000-rung DDPM ladder: the same indices (the
    ladder's own values among the sigmas), the quantized sigma and c_noise,
    and D(x, sigma) of a toy network, against JAX's."""
    scfg = {"target": "sgm.modules.diffusionmodules.denoiser_scaling." + scaling}
    rng = np.random.default_rng(4)
    ladder = j_instantiate(DDPM_LADDER)(1000, do_append_zero=False, flip=True)
    sigma = np.concatenate([rng.uniform(0.03, 15.0, 13), ladder[[0, 17, 999]]]).astype(np.float32)
    ref = j_instantiate(scfg)(jnp.asarray(sigma))
    got = instantiate_from_config(scfg)(torch.from_numpy(sigma))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.broadcast_to(np.asarray(r), sigma.shape),
                                   rtol=1e-6, atol=1e-6)

    dcfg = {"target": "sgm.modules.diffusionmodules.denoiser.DiscreteDenoiser",
            "params": {"scaling_config": scfg, "num_idx": 1000,
                       "discretization_config": DDPM_LADDER}}
    jd, d = j_instantiate(dcfg), instantiate_from_config(dcfg)
    np.testing.assert_array_equal(d.sigmas, np.asarray(jd.sigmas))
    np.testing.assert_array_equal(d.sigma_to_idx(torch.from_numpy(sigma)).numpy(),
                                  np.asarray(jd.sigma_to_idx(jnp.asarray(sigma))))
    x = rng.normal(size=(16, 2, 3, 3)).astype(np.float32)
    seen = {}

    def network(xx, c_noise, cond):
        seen["port"] = c_noise.numpy()
        return torch.tanh(xx) * 0.5 + cond["shift"]

    def j_denoise(x, s):
        def j_network(xx, c_noise, cond):
            seen["jax"] = c_noise
            return jnp.tanh(xx) * 0.5 + cond["shift"]

        return jd(j_network, x, s, {"shift": 0.25}), seen["jax"]

    out = d(network, torch.from_numpy(x), torch.from_numpy(sigma), {"shift": torch.tensor(0.25)})
    ref, c_noise = jax.jit(j_denoise)(x, sigma)
    np.testing.assert_array_equal(seen["port"], np.asarray(c_noise))
    assert rel_l2(out.numpy(), ref) <= 1e-6


def test_sgm_names_instantiate_on_both_sides():
    """The slice's sgm names: the same dict instantiates on both sides."""
    dd = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], z_channels=4,
              double_z=True, in_channels=3, out_ch=3, resolution=32, dropout=0.0)
    configs = [_config(n) for n in SAMPLERS] + [
        {"target": "sgm.modules.diffusionmodules.guiders.IdentityGuider"},
        {"target": "sgm.modules.diffusionmodules.guiders.VanillaCFG", "params": {"scale": 2.0}},
        {"target": "sgm.modules.diffusionmodules.denoiser.DiscreteDenoiser", "params": {
            "scaling_config": {"target": "sgm.modules.diffusionmodules.denoiser_scaling."
                               "EpsScaling"},
            "num_idx": 1000, "discretization_config": DDPM_LADDER}},
        DDPM_LADDER,
        {"target": "sgm.modules.autoencoding.losses.lpips.LatentLPIPS", "params": {
            "decoder_config": {"target": "sgm.models.autoencoder.AutoencoderKLModeOnly",
                               "params": {"embed_dim": 4, "ddconfig": dd}}}},
        {"target": "sgm.modules.encoders.modules.InceptionV3",
         "params": {"output_blocks": [0, 3], "normalize_input": True}},
    ] + [{"target": "sgm.modules.diffusionmodules.denoiser_scaling." + s} for s in SCALINGS]
    names = set()
    for cfg in configs:
        j_instantiate(copy.deepcopy(cfg))
        port = instantiate_from_config(copy.deepcopy(cfg))
        assert type(port).__module__.startswith("gcd_tpu_torch.")
        names.add(cfg["target"])
    assert len(names - {"sgm.modules.diffusionmodules.denoiser_scaling."
                        "VScalingWithEDMcNoise"}) == 16


def _tiny_engine_case(sampler_config, steps, jax_seed=3):
    """sample_video of configs/smoke_kubric_tiny.yaml with `sampler_config`
    on both sides: JAX's latent noise normal(split(key)[0]) and its
    per-step noise from split(key)[1] passed to the port."""
    cfg = load_config(TINY_CONFIG)["model"]
    cfg["params"]["sampler_config"] = sampler_config
    batch = tiny_batch(T, 32, 48, 8)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jeng = j_instantiate(copy.deepcopy(cfg))
    params = engine_params(jeng, batch, 20)
    key = jax.random.PRNGKey(jax_seed)
    ref = jax.jit(lambda p, b, k: jeng.sample_video(p, b, k, num_steps=steps,
                                                    return_latents=True))(params, jbatch, key)
    k_noise, k_samp = jax.random.split(key)
    noise = np.array(jax.random.normal(k_noise, (T, 4, 6, 4), dtype=jnp.float32))

    emb_models = cfg["params"]["conditioner_config"]["params"]["emb_models"]
    engine = engine_from_config(cfg, device="cpu", dtype=torch.float32,
                                state_dict=engine_state_dict(params, emb_models, 30))
    step_noise = None
    if engine.sampler.needs_step_noise:
        step_noise = _cf(_jax_step_noise(k_samp, steps, (T, 4, 6, 4)))
    out = engine.sample_video({k: torch.from_numpy(v) for k, v in batch.items()},
                              noise=torch.from_numpy(noise), num_steps=steps,
                              return_latents=True, step_noise=step_noise)
    assert out["sampled_video"].shape == (T, 32, 48, 3) == ref["sampled_video"].shape
    assert np.asarray(ref["sampled_video"]).std() > 1e-2
    assert rel_l2(out["sampled_z"].numpy(), ref["sampled_z"]) <= 1e-3
    assert rel_l2(out["sampled_video"].numpy(), ref["sampled_video"]) <= 1e-3
    return engine


@pytest.mark.parametrize("name,steps", [("EulerAncestralSampler", 4), ("HeunEDMSampler", 3)])
def test_tiny_sample_video_matches_jax(name, steps):
    """The whole tiny engine with the config's ladder and guider:
    Euler-ancestral over its 4 steps with JAX's per-step noise, Heun over 3
    steps with its 5 evaluations. (At 2 or 3 steps of this ladder, JAX's
    jitted ancestral step on the CPU turns the frames NaN: a step whose
    sigma_up rounds to its next sigma gets sigma_down = sqrt(next^2 -
    sigma_up^2) of a negative rounding residue there, where the port's host
    float32 gets 0.)"""
    cfg = load_config(TINY_CONFIG)["model"]["params"]["sampler_config"]
    cfg["target"] = SAMPLING + name
    _tiny_engine_case(cfg, steps)


def test_tiny_engine_identity_guider():
    """An engine whose sampler has no guider_config (IdentityGuider, which
    has no num_frames): T comes from the batch's indicator, every UNet
    evaluation is the undoubled B*T rows; against JAX's engine."""
    cfg = load_config(TINY_CONFIG)["model"]["params"]["sampler_config"]
    cfg["params"].pop("guider_config")
    cfg["params"]["guidance_interval"] = None
    engine = _tiny_engine_case(cfg, 2)
    assert not hasattr(engine.sampler.guider, "num_frames")


def test_export_refuses_other_samplers(monkeypatch):
    """The two configurations export_sampler once refused, Heun and Euler
    with churn (per-step noise), now export: their artifact holds the
    conditioner, the sampler's evaluation (not Euler's step) and the
    decode, and its header records the sampler, its scalars, the ladder,
    the plan and whether it draws per-step noise. The programs' tracing is
    stubbed here (tests/test_torch_export_samplers.py traces, loads and
    runs such artifacts against sample_video bit for bit)."""
    import io
    import json
    import zipfile

    from gcd_tpu_torch.engine import export

    monkeypatch.setattr(export, "_export", lambda body, params, inputs: (
        b"", {"body": type(body).__name__, "guided": body.guided if hasattr(body, "guided")
              else None, "inputs": [list(t.shape) for t in inputs]}))
    model = load_config(TINY_CONFIG)["model"]
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch(T, 32, 48, 8).items()}
    for target, extra, noise in (("HeunEDMSampler", {}, False),
                                 ("EulerEDMSampler", {"s_churn": 1.0}, True)):
        cfg = copy.deepcopy(model)
        cfg["params"]["sampler_config"]["target"] = SAMPLING + target
        cfg["params"]["sampler_config"]["params"].update(extra)
        engine = engine_from_config(cfg, device="cpu", dtype=torch.float32)
        blob = export_sampler(engine, {}, batch, num_steps=3, decoding_t=T)
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            header = json.loads(zf.read("header.json"))
        programs = header["programs"]
        assert sorted(programs) == ["cond", "decode", "eval"]
        assert programs["eval"]["body"] == "_Evaluation" and programs["eval"]["guided"]
        assert programs["eval"]["inputs"][:3] == [[T, 4, 4, 6], [T], [1, T]]
        record = header["sampler"]
        assert record["target"] == SAMPLING + target and record["step_noise"] is noise
        assert record["scalars"]["s_churn"] == extra.get("s_churn", 0.0)
        assert record["sigmas"] == [float(s) for s in engine.sampler.sigmas(3)]
        evals = [len(p["evals"]) for p in record["plan"]]
        assert evals == ([2, 2, 1] if target == "HeunEDMSampler" else [1, 1, 1])

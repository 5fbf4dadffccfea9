"""Every sgm sampler through the exported sampler (gcd_tpu_torch/engine/export.py)
on the CPU, against the port's own engine.sample_video.

The port's sample_video is held against JAX's for these samplers in
tests/test_torch_samplers.py; here the artifact must reproduce it bit for
bit: the same latent noise and per-step noise (made with numpy), or the
same generator seed, go through engine.sample_video and through
load_sampler(export_sampler(...)). Both run the sampler's one `run` over
the same host plan, the artifact's evaluations being the torch.export
programs of the eager ones, so nothing may differ (the engine is frozen,
as tests/test_torch_export.py explains: on the CPU a convolution's
algorithm depends on whether its weight requires grad).

The engine is configs/smoke_kubric_tiny.yaml with its UNet cut to one
level (channel_mult [1], attention at it: half the tiny UNet's trace), its
seeded random weights, fp32, one 3-frame 32x48 clip, 4 steps of its ladder (700, 18.1,
0.214, 0.002); it is built once, and each sampler is exported once. The
six artifacts hold the same conditioner, decode and evaluation programs
(one engine, one guider: what differs is the header's sampler record and
whether a plain evaluation is exported), so the module traces each
distinct program once and deserialises each distinct program file once
(`_export` and `torch.export.load` memoised for the module): every
export_sampler and load_sampler call still runs whole, and a tiny trace
costs ~10 s.
"""

import copy
import io

import numpy as np
import pytest
import torch

from gcd_tpu_torch.engine import export
from gcd_tpu_torch.engine.build import engine_from_config
from gcd_tpu_torch.engine.export import export_sampler, load_sampler
from gcd_tpu_torch.engine.server import SamplerServer, make_engine_sample_fn
from gcd_tpu_torch.serve import load_artifact
from gcd_tpu_torch.utils.config import instantiate_from_config, load_config
from tests.torch_port_helpers import TINY_CONFIG, tiny_batch
from tests.torch_threads import one_torch_thread  # noqa: F401

T, H, W = 3, 32, 48
STEPS = 4
SAMPLING = "sgm.modules.diffusionmodules.sampling."
# (case, sampler, its params): EDMSampler churns the middle of the ladder;
# Heun's guidance_interval (10, 100) guides the evaluations at 18.1 only,
# so the first step's second evaluation (at 18.1) is guided and the second
# step's (at 0.214) is not.
SAMPLERS = {
    "EDMSampler_churn": ("EDMSampler", {"s_churn": 1.0, "s_tmin": 0.1, "s_tmax": 50.0}),
    "HeunEDMSampler_interval": ("HeunEDMSampler", {"guidance_interval": [10.0, 100.0]}),
    "EulerAncestralSampler": ("EulerAncestralSampler", {"eta": 0.8}),
    "DPMPP2SAncestralSampler": ("DPMPP2SAncestralSampler", {}),
    "DPMPP2MSampler": ("DPMPP2MSampler", {}),
    "LinearMultistepSampler": ("LinearMultistepSampler", {"order": 3}),
}


@pytest.fixture(scope="module")
def tiny():
    """The tiny engine, frozen, the clip, and a cache of each case's
    artifact (exported on first use), with the programs' traces and
    loads memoised (module docstring)."""
    cfg = load_config(TINY_CONFIG)["model"]
    cfg["params"]["network_config"]["params"].update(channel_mult=[1], attention_resolutions=[1])
    engine = engine_from_config(cfg, device="cpu", dtype=torch.float32)
    engine.requires_grad_(False)
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch(T, H, W, 4).items()}
    traced, loaded = {}, {}
    trace, load = export._export, torch.export.load

    def traced_once(body, params, inputs):
        key = (type(body).__name__, getattr(body, "guided", None),
               tuple(tuple(t.shape) for t in inputs))
        if key not in traced:
            traced[key] = trace(body, params, inputs)
        return traced[key]

    def loaded_once(f):
        data = f.read()
        if data not in loaded:
            loaded[data] = load(io.BytesIO(data))
        return loaded[data]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(export, "_export", traced_once)
        mp.setattr(torch.export, "load", loaded_once)
        yield {"engine": engine, "batch": batch, "blobs": {}}


def _use(tiny, case):
    """The engine with the case's sampler (the config's ladder and
    guider), its artifact and the loaded sampler."""
    engine = tiny["engine"]
    name, extra = SAMPLERS[case]
    cfg = copy.deepcopy(load_config(TINY_CONFIG)["model"]["params"]["sampler_config"])
    cfg["target"] = SAMPLING + name
    cfg["params"].update(copy.deepcopy(extra))
    engine.sampler = instantiate_from_config(cfg)
    if case not in tiny["blobs"]:
        tiny["blobs"][case] = export_sampler(engine, engine.state_dict(), tiny["batch"],
                                             num_steps=STEPS, decoding_t=T)
    return engine, tiny["blobs"][case], load_sampler(tiny["blobs"][case])


def _noise(seed, steps=STEPS):
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((T, H // 8, W // 8, 4)).astype(np.float32)
    step_noise = rng.standard_normal((steps, T, 4, H // 8, W // 8)).astype(np.float32)
    return torch.from_numpy(noise), torch.from_numpy(step_noise)


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", list(SAMPLERS))
def test_exported_sampler_matches_sample_video(tiny, case):
    """Each sampler's artifact, with the latent and per-step noise passed
    in, gives engine.sample_video's frames bit for bit; its programs are
    the conditioner, the decode and the evaluation (plain too where the
    guidance_interval leaves an evaluation unguided), and its header
    records the sampler."""
    engine, _, sample = _use(tiny, case)
    noise, step_noise = _noise(7)
    extra = {"step_noise": step_noise} if engine.sampler.needs_step_noise else {}
    want = engine.sample_video(tiny["batch"], noise=noise, num_steps=STEPS, decoding_t=T,
                               **extra)
    got = sample(engine.state_dict(), tiny["batch"], noise=noise, **extra)
    _equal(got, want)
    assert want["sampled_video"].std() > 1e-3
    guided = engine.sampler.guided_evaluations(STEPS)
    plain = ["eval_plain"] * (not all(g for step in guided for g in step))
    assert sorted(sample.programs) == sorted(["cond", "decode", "eval", *plain])
    record = sample.header["sampler"]
    assert record["target"] == SAMPLING + SAMPLERS[case][0]
    assert record["step_noise"] == engine.sampler.needs_step_noise
    assert len(record["plan"]) == STEPS == len(sample.header["sigmas"]) - 1
    if case == "HeunEDMSampler_interval":
        assert guided == [[False, True], [True, False], [False, False], [False]]
    if case == "EDMSampler_churn":
        assert 0 < sum(p["bump"] > 0 for p in record["plan"]) < STEPS


def test_exported_sampler_draws_sample_video_s_noise(tiny):
    """Without noise, the artifact draws the latent noise and then the
    per-step noise from the generator, as sample_video does: the same seed
    gives the same frames."""
    engine, _, sample = _use(tiny, "DPMPP2SAncestralSampler")
    want = engine.sample_video(tiny["batch"], generator=torch.Generator().manual_seed(11),
                               num_steps=STEPS, decoding_t=T)
    got = sample(engine.state_dict(), tiny["batch"], generator=torch.Generator().manual_seed(11))
    _equal(got, want)
    other = sample(engine.state_dict(), tiny["batch"], generator=torch.Generator().manual_seed(12))
    assert not torch.equal(other["sampled_video"], want["sampled_video"])


def test_exported_sampler_refuses_a_wrong_step_noise(tiny):
    engine, _, sample = _use(tiny, "EulerAncestralSampler")
    noise, step_noise = _noise(3, STEPS - 1)
    with pytest.raises(ValueError, match=r"step_noise must be \(4, 3, 4, 4, 6\)"):
        sample(engine.state_dict(), tiny["batch"], noise=noise, step_noise=step_noise)


def test_artifact_server_serves_the_eager_ancestral_frames(tiny, tmp_path):
    """serve.py's --artifact path (load_artifact: the artifact's file, each
    request's latent and per-step noise from its seed) behind
    SamplerServer, against the eager server on the same requests and
    seeds: bit for bit."""
    engine, blob, _ = _use(tiny, "EulerAncestralSampler")
    path = tmp_path / "ancestral.gcdexp"
    path.write_bytes(blob)
    clip = {k: v.numpy() for k, v in tiny["batch"].items()}
    fn, check = load_artifact(str(path), engine.state_dict(), 1, T, (H, W))
    served = SamplerServer(fn, T, max_batch=1, max_wait_ms=10, check=check).start()
    eager = SamplerServer(make_engine_sample_fn(engine, 1, T, num_steps=STEPS, decoding_t=T),
                          T, max_batch=1, max_wait_ms=10).start()
    try:
        got = [served.submit(clip, seed=s).result(timeout=120) for s in (5, 6)]
        want = [eager.submit(clip, seed=s).result(timeout=120) for s in (5, 6)]
    finally:
        served.stop()
        eager.stop()
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.array_equal(g[k], w[k]), k
    assert not np.array_equal(got[0]["sampled_video"], got[1]["sampled_video"])

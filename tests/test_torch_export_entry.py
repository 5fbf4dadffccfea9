"""The port's export entry (gcd_tpu_torch/export_artifact.py, the counterpart
of scripts/export_artifact.py) on the CPU, and its artifact against JAX's.

The entry exports configs/smoke_kubric_tiny.yaml (JAX's tiny engine: B = 1,
T = 3, 32x48, 3 steps, a 3-frame decode, full CFG at every step, the guider
scaled 1 to 1.5 as load_model_bundle sets it) once. Its artifact samples
the bundle's seeded weights as the direct `sample_video` does, within 1e-5
(measured 0; the engine's parameters frozen, as in test_torch_export.py).
Its weights are inputs, so the same artifact also runs JAX's tiny engine's
seeded weights carried across with io/convert.py: against gcd_tpu's
load_sampler(export_sampler()) of that engine, JAX's latent noise
normal(split(key)[0]) passed in, within 1e-3 relative L2 (the bound of
tests/test_torch_slice.py for the tiny engine).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.engine.export import export_sampler as j_export_sampler
from gcd_tpu.engine.export import load_sampler as j_load_sampler
from gcd_tpu.utils.config import instantiate_from_config as j_instantiate
from gcd_tpu_torch import export_artifact
from gcd_tpu_torch.engine.bundle import load_model_bundle
from gcd_tpu_torch.engine.export import load_sampler
from tests.helpers import tiny_engine_config
from tests.torch_port_helpers import (TINY_CONFIG, engine_params, engine_state_dict, rel_l2,
                                      tiny_batch)
from tests.torch_threads import one_torch_thread  # noqa: F401

B, T, H, W = 1, 3, 32, 48
STEPS = 3
GUIDER = {"num_frames": T, "max_scale": 1.5, "min_scale": 1.0}  # load_model_bundle's


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    """The entry's artifact (bytes), and the file it wrote."""
    path = tmp_path_factory.mktemp("export") / "tiny.gcdexp"
    blob = export_artifact.main(["--config_path", TINY_CONFIG, "--output", str(path),
                                 "--random_init", "--device", "cpu", "--num_frames", str(T),
                                 "--frame_height", str(H), "--frame_width", str(W),
                                 "--num_steps", str(STEPS), "--decoding_t", str(T)])
    return blob, path


def _arrays(engine, seed):
    """The entry's example batch (zero frames and camera moves) filled with
    a seeded clip, and its target frames."""
    batch = engine.example_batch((H, W), T, B)
    del batch["num_video_frames"]
    clip = tiny_batch(T, H, W, seed)
    batch.update({k: torch.from_numpy(v) for k, v in clip.items()},
                 jpg=torch.from_numpy(tiny_batch(T, H, W, seed + 1)["cond_frames_without_noise"]))
    return batch, clip


def _noise(seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B * T, H // 8, W // 8, 4)).astype(np.float32))


def test_export_entry_on_cpu(entry):
    """python -m gcd_tpu_torch.export_artifact --random_init --device cpu
    writes an artifact of the three programs that loads and samples the
    config's seeded weights as the direct call does, within 1e-5."""
    blob, path = entry
    assert path.read_bytes() == blob
    engine = load_model_bundle(TINY_CONFIG, None, num_steps=STEPS, num_frames=T, device="cpu",
                               dtype=torch.float32).engine.requires_grad_(False)
    batch, _ = _arrays(engine, 6)
    sample = load_sampler(blob)
    assert sorted(sample.programs) == ["cond", "decode", "step"]
    out = sample(engine.state_dict(), batch, noise=_noise(3))
    ref = engine.sample_video(batch, noise=_noise(3), decoding_t=T)
    assert sorted(out) == sorted(ref) == ["cond_video", "gt_video", "sampled_video"]
    assert out["sampled_video"].shape == (B * T, H, W, 3)
    for key in out:
        np.testing.assert_allclose(out[key].numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-5)


def test_artifact_matches_jax_artifact(entry):
    """The entry's artifact on JAX's tiny engine's weights against gcd_tpu's
    load_sampler(export_sampler()) of that engine, JAX's latent noise
    normal(split(key)[0]) passed in: relative L2 <= 1e-3 on sampled_video."""
    cfg = tiny_engine_config()
    cfg["params"]["sampler_config"]["params"]["guider_config"]["params"].update(GUIDER)
    jeng = j_instantiate(copy.deepcopy(cfg))
    engine = load_model_bundle(TINY_CONFIG, None, num_steps=STEPS, num_frames=T, device="cpu",
                               dtype=torch.float32).engine
    batch, clip = _arrays(engine, 8)
    params = engine_params(jeng, clip, 20)
    emb_models = cfg["params"]["conditioner_config"]["params"]["emb_models"]
    state = engine_state_dict(params, emb_models, 30)
    assert sorted(state) == sorted(engine.state_dict())

    jbatch = jax.tree_util.tree_map(jnp.asarray, clip)
    key = jax.random.PRNGKey(7)
    ref = j_load_sampler(j_export_sampler(jeng, params, jbatch, num_steps=STEPS,
                                          decoding_t=T))(params, jbatch, key)
    noise = jax.random.normal(jax.random.split(key)[0], (B * T, H // 8, W // 8, 4),
                              dtype=jnp.float32)
    out = load_sampler(entry[0])(state, batch, noise=torch.from_numpy(np.array(noise)))
    assert np.asarray(ref["sampled_video"]).std() > 1e-2
    assert rel_l2(out["cond_video"].numpy(), ref["cond_video"]) <= 1e-6
    assert rel_l2(out["sampled_video"].numpy(), ref["sampled_video"]) <= 1e-3


def test_export_entry_needs_a_card_or_device_cpu(tmp_path, monkeypatch):
    """Without CUDA and without --device cpu the entry raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        export_artifact.main(["--config_path", TINY_CONFIG, "--output",
                              str(tmp_path / "x.gcdexp"), "--random_init"])

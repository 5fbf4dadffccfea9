"""The port's inference and evaluation entries (gcd_tpu_torch/infer.py,
gcd_tpu_torch/test.py) and what they share (gcd_tpu_torch/eval_utils.py)
on the CPU: configs/smoke_kubric_tiny.yaml (and, for the semantic head's
mIoU, configs/smoke_pardom_tiny.yaml) on a synthetic root, 3 frames of
48x32, 2 steps, in fp32.

The entries' metrics are held against the JAX package's metric functions
(gcd_tpu/utils/metrics.py) applied to the frames the port sampled, at
1e-10 (float64 numpy on both sides); the controls and the scene list
against scripts/test.py's, exactly; DiffusionEngine.validation_metrics
against sample_video's frames through the JAX package's psnr and ssim.
"""

import json
import os

import numpy as np
import pytest
import torch

from gcd_tpu.utils import metrics as jmetrics
from gcd_tpu_torch import eval_utils, infer
from gcd_tpu_torch import test as test_entry
from gcd_tpu_torch.data.fake import class_ontology_items, make_kubric_root, make_pardom_root
from gcd_tpu_torch.data.png import read_png, write_png
from gcd_tpu_torch.engine.build import load_engine
from gcd_tpu_torch.utils.config import (apply_dotlist, instantiate_from_config, load_config,
                                        save_config)
from scripts import test as jtest
from tests.torch_port_helpers import TINY_CONFIG, tiny_batch

T, H, W = 3, 32, 48
TOL = 1e-10
SMALL = ["--device", "cpu", "--num_frames", str(T), "--frame_width", str(W),
         "--frame_height", str(H), "--num_steps", "2", "--decoding_t", str(T)]
SCALARS = ("psnr", "ssim", "diversity_std", "psnr_visible", "psnr_occluded", "ssim_visible",
           "ssim_occluded")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    PyTorch's thread pool oversubscribed by them slows these tiny ops
    several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    """The tiny config with its data section on a synthetic root."""
    root = str(tmp_path_factory.mktemp("eval_root"))
    make_kubric_root(root)
    cfg = apply_dotlist(load_config(TINY_CONFIG), [f"data.params.dset_root={root}/data",
                                                   f"data.params.pcl_root={root}/pcl"])
    path = os.path.join(root, "smoke_kubric_tiny.yaml")
    save_config(cfg, path)
    return path


@pytest.fixture
def recorded(monkeypatch):
    """Every (batch, outputs) the entries' samplers see."""
    calls = []
    make = eval_utils.make_sampler

    def recording(*args, **kwargs):
        sample = make(*args, **kwargs)

        def wrapped(batch, seed):
            out = sample(batch, seed)
            calls.append((batch, out))
            return out

        return wrapped

    monkeypatch.setattr(eval_utils, "make_sampler", recording)
    return calls


def _same(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0.0, atol=TOL, equal_nan=True)


def test_test_entry_metrics_match_jax(config, recorded, tmp_path):
    out = str(tmp_path / "test")
    results = test_entry.main(["--config_path", config, "--input", "0", "--generate_controls",
                               "--samples_per_scene", "1", "--num_samples", "1",
                               "--output", out, *SMALL])
    assert len(results) == 1 and results[0]["failed"] == []
    model_dp = os.path.join(out, "random")
    # The default galleries: rich5 needs two samples; the rest are written.
    galleries = [f"0_sample_00_{g}.{ext}" for g in ("err", "gal", "io", "proj")
                 for ext in ("npz", "png")]
    assert sorted(os.listdir(model_dp)) == sorted(
        galleries + ["0_sample_00_metrics.json", "0_sample_00_out0.npz",
                     "0_sample_00_out0.png", "summary_metrics.json"])
    with open(os.path.join(model_dp, "summary_metrics.json")) as f:
        summary = json.load(f)
    assert set(SCALARS) <= set(summary["summary"]) and len(summary["examples"]) == 1
    assert summary["summary"] == results[0]["summary"]

    [(batch, sampled)] = recorded
    frames = sampled["sampled_video"]
    gt = (batch["jpg"] + 1.0) / 2.0
    reproject = (batch["reproject"] + 1.0) / 2.0
    assert frames.shape == gt.shape == reproject.shape == (T, H, W, 3)
    visible = (reproject.sum(-1) > 0.05).mean()
    assert 0.0 < visible < 1.0
    assert summary["examples"][0]["visible_share"] == visible
    want, _ = jmetrics.clip_metrics([frames], gt, reproject)
    with open(os.path.join(model_dp, "0_sample_00_metrics.json")) as f:
        got = json.load(f)
    for k, v in want.items():
        assert np.asarray(got[k]).shape == np.asarray(v).shape, k
        _same(np.asarray(got[k], np.float64), v)
    assert np.asarray(got["frame_psnr"]).shape == (1, T)
    _same(got["psnr"], np.nanmean(want["frame_psnr"]))
    _same(got["ssim_occluded"], np.nanmean(want["frame_ssim_occ"]))
    _same(got["diversity_std"], jmetrics.sample_diversity([frames]))
    assert got["control"] == summary["examples"][0]["control"]
    with np.load(os.path.join(model_dp, "0_sample_00_out0.npz")) as z:
        assert np.array_equal(z["frames"], eval_utils.to_uint8(frames))
    assert read_png(os.path.join(model_dp, "0_sample_00_out0.png")).shape == (H, T * W, 3)


def test_test_entry_on_a_semantic_pardom_config(tmp_path, recorded):
    """configs/smoke_pardom_tiny.yaml (a `segm` output) on a tiny
    ParallelDomain root whose points carry class colours: the example is
    rendered by scene name, and its mIoU is the JAX package's over the
    frames, matched to the ontology's colours."""
    root = str(tmp_path / "pd")
    make_pardom_root(root, ontology_items=class_ontology_items(), segm_cell=3.0)
    cfg = apply_dotlist(load_config(os.path.join(os.path.dirname(TINY_CONFIG),
                                                  "smoke_pardom_tiny.yaml")),
                        [f"data.params.dset_root={root}/data", f"data.params.pcl_root={root}/pcl",
                         f"data.params.split_json={root}/data/pardom_datasplit.json"])
    config = str(tmp_path / "pd.yaml")
    save_config(cfg, config)
    [res] = test_entry.main(["--config_path", config, "--input", "scene_000000",
                             "--generate_controls", "--samples_per_scene", "1",
                             "--num_samples", "1", "--output", str(tmp_path / "out"), *SMALL])
    [example] = res["examples"]
    assert res["failed"] == [] and example["scene"] == "scene_000000"
    assert 1 <= example["control"]["frame_skip"] <= 2
    [(batch, sampled)] = recorded
    palette = np.asarray(instantiate_from_config(cfg["data"]).val_dataset.ontology[
        "semantic_id_rgb_map"])
    gt = (batch["jpg"] + 1.0) / 2.0
    want = np.nanmean([jmetrics.miou(jmetrics.rgb_to_class_ids(f, palette),
                                     jmetrics.rgb_to_class_ids(g, palette))
                       for f, g in zip(sampled["sampled_video"], gt)])
    _same(example["miou"], want)
    _same(res["summary"]["miou"], want)


def test_infer_entry_writes_its_outputs(config, recorded, tmp_path):
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    rng = np.random.default_rng(0)
    np.savez(inputs / "clip.npz", frames=rng.integers(0, 256, (4, 40, 60, 3), dtype=np.uint8))
    write_png(str(inputs / "still.png"), rng.integers(0, 256, (50, 70, 3), dtype=np.uint8))
    out = str(tmp_path / "infer")
    result = infer.main(["--config_path", config, "--input", str(inputs), "--num_samples", "2",
                         "--input_frames", str(T), "--output", out, *SMALL])
    names = [f"{base}_{kind}.{ext}" for base in ("clip", "still")
             for kind in ("in", "ioside", "out0", "out1") for ext in ("npz", "png")]
    assert sorted(os.listdir(out)) == sorted(names + ["clip_metrics.json",
                                                      "still_metrics.json", "summary.json"])
    assert len(recorded) == 4 and result["summary"]["num_examples"] == 2
    for i, base in enumerate(("clip", "still")):
        samples = [recorded[2 * i + s][1]["sampled_video"] for s in range(2)]
        with open(os.path.join(out, f"{base}_metrics.json")) as f:
            metrics = json.load(f)
        _same(metrics["diversity_std"], jmetrics.sample_diversity(samples))
        assert metrics["diversity_std"] > 0.0
        for s in range(2):
            with np.load(os.path.join(out, f"{base}_out{s}.npz")) as z:
                assert z["frames"].shape == (T, H, W, 3) and int(z["fps"]) == 12
                assert np.array_equal(z["frames"], eval_utils.to_uint8(samples[s]))
        with np.load(os.path.join(out, f"{base}_ioside.npz")) as z:
            assert z["frames"].shape == (T, H, 2 * W, 3)
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == result


def test_entries_need_cuda_unless_cpu_is_asked_for(config, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_entry.main(["--config_path", config, "--input", "0", "--output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["--config_path", config, "--input", str(tmp_path), "--output",
                    str(tmp_path)])


def test_controls_and_scene_list_are_the_jax_entrys(config, tmp_path):
    """generate_controls draws what scripts/test.py draws for the same train
    config; a scene list parses the same."""
    cfg = load_config(config)
    bundle = type("Bundle", (), {"train_config": cfg, "delta_azimuth_range": [0.0, 0.0],
                                 "delta_elevation_range": [0.0, 0.0],
                                 "delta_radius_range": [0.0, 0.0]})()
    for scenes in ([0], [3, "scene_000007"]):
        assert (test_entry.generate_controls(scenes, 3, bundle)
                == jtest.generate_controls(scenes, 3, bundle, seed=4))
    pd = dict(cfg, data=dict(cfg["data"], target="sgm.data.pardom_arbit.X"))
    bundle.train_config = pd
    assert (test_entry.generate_controls(["scene_000001"], 2, bundle)
            == jtest.generate_controls(["scene_000001"], 2, bundle, seed=4))
    listing = tmp_path / "scenes.txt"
    listing.write_text("/data/kubric/scn02900\n\n/pd/scene_000004/\nother\n")
    for spec in (str(listing), "1, 22,scene_000003"):
        assert test_entry.parse_scene_list(spec) == jtest.parse_scene_list(spec)


def test_load_image_or_video(tmp_path):
    rng = np.random.default_rng(1)
    clip = rng.integers(0, 256, (5, 64, 96, 3), dtype=np.uint8)
    np.savez(tmp_path / "u8.npz", frames=clip)
    np.savez(tmp_path / "f32.npz", frames=clip.astype(np.float32) / 255.0)
    got = eval_utils.load_image_or_video(str(tmp_path / "u8.npz"), 4, frame_offset=1,
                                         frame_stride=2, frame_width=W, frame_height=H)
    assert got.shape == (4, H, W, 3) and got.dtype == np.float32
    assert np.array_equal(got, eval_utils.load_image_or_video(
        str(tmp_path / "f32.npz"), 4, frame_offset=1, frame_stride=2, frame_width=W,
        frame_height=H))
    assert np.array_equal(got[2], got[3])  # frames 5 and 7 clip to the last, 4
    write_png(str(tmp_path / "gray.png"), clip[0, ..., :1])
    gray = eval_utils.load_image_or_video(str(tmp_path / "gray.png"), 2, frame_width=W,
                                          frame_height=H)
    assert gray.shape == (2, H, W, 3) and np.array_equal(gray[..., 0], gray[..., 2])
    np.savez(tmp_path / "bad.npz", frames=clip.astype(np.float32))
    for name, match in (("bad.npz", r"outside \[0, 1\]"), ("a.mp4", "video codec"),
                        ("a.jpg", "jpg image decoder")):
        with pytest.raises(ValueError, match=match):
            eval_utils.load_image_or_video(str(tmp_path / name), 2)
    (tmp_path / "list.txt").write_text("# inputs\nu8.npz\ngray.png\n")
    assert eval_utils.resolve_input_paths(str(tmp_path / "list.txt")) == [
        str(tmp_path / "u8.npz"), str(tmp_path / "gray.png")]
    assert eval_utils.resolve_input_paths(str(tmp_path)) == sorted(
        str(tmp_path / n) for n in ("bad.npz", "f32.npz", "gray.png", "u8.npz"))


def test_write_video_and_frames_writes_rgb_pngs(tmp_path):
    video = np.random.default_rng(2).random((3, 8, 10, 3)).astype(np.float32)
    eval_utils.write_video_and_frames(str(tmp_path), "v", video, fps=5, save_frames=True)
    frames = eval_utils.to_uint8(video)
    with np.load(tmp_path / "v.npz") as z:
        assert np.array_equal(z["frames"], frames) and int(z["fps"]) == 5
    for i in range(3):
        assert np.array_equal(read_png(str(tmp_path / "v" / f"{i:04d}.png")), frames[i])
    assert read_png(str(tmp_path / "v.png")).shape == (8, 30, 3)


def test_validation_metrics_are_sample_videos_psnr_and_ssim():
    engine = load_engine(TINY_CONFIG, device="cpu", dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch(T, H, W, 5).items()}
    batch["jpg"] = batch["cond_frames_without_noise"].flip(0)
    noise = torch.from_numpy(np.random.default_rng(6).normal(
        size=(T, H // 8, W // 8, 4)).astype(np.float32))
    got = engine.validation_metrics(batch, noise=noise, decoding_t=T)
    out = engine.sample_video(batch, noise=noise, decoding_t=T)
    pred, gt = out["sampled_video"].numpy(), out["gt_video"].numpy()
    assert sorted(got) == ["val/psnr", "val/ssim"]
    _same(got["val/psnr"], np.mean([jmetrics.psnr(p, g) for p, g in zip(pred, gt)]))
    _same(got["val/ssim"], np.mean([jmetrics.ssim(p, g) for p, g in zip(pred, gt)]))

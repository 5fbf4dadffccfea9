"""The port's training entry (gcd_tpu_torch/train.py) on the CPU: the tiny
config (configs/smoke_kubric_tiny.yaml) trained on a synthetic root, its CSV
rows, its `step_N` checkpoints, a resume that restores the trainer bit for
bit and steps on as the saved trainer would, the image log, serving a run's
checkpoint with load_model_bundle (and its guidance_interval), and the
refusals (no CUDA, orbax run directories).

Everything runs in fp32 on the CPU, so a restored trainer's next step on the
same batch and generator equals the saved trainer's bit for bit.
"""

import copy
import csv
import os
import signal

import numpy as np
import pytest
import torch

from gcd_tpu_torch import train
from gcd_tpu_torch.data.fake import make_kubric_root
from gcd_tpu_torch.data.loader import batch_to_device
from gcd_tpu_torch.engine.bundle import camera_metadata, construct_batch, load_model_bundle
from gcd_tpu_torch.io.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from gcd_tpu_torch.utils.config import apply_dotlist, instantiate_from_config, load_config
from tests.torch_port_helpers import TINY_CONFIG

T, H, W = 3, 32, 48


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    PyTorch's thread pool oversubscribed by them slows these tiny ops
    several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(root):
    return [f"data.params.dset_root={root}/data", f"data.params.pcl_root={root}/pcl"]


def _args(root, logdir, *extra):
    return ["--device", "cpu", "-b", TINY_CONFIG, "-l", logdir, *_data(root),
            "lightning.modelcheckpoint.params.every_n_train_steps=2",
            "lightning.callbacks.image_logger.params.batch_frequency=4", *extra]


def _same_state(a, b):
    """Nested dicts / lists of tensors, equal bit for bit."""
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_state(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    return a == b


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _fixed_step(trainer, batch):
    """One step on `batch` with a fixed generator: (loss, masters after)."""
    metrics = trainer.train_step(batch, torch.Generator().manual_seed(7))
    return float(metrics["loss"]), [m.clone() for m in trainer.masters]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run A: two steps from scratch (a checkpoint at step 2), then one more
    step on a fixed batch from its trainer. Run B: --resume to step 4, its
    restored state taken before it trains."""
    tmp = tmp_path_factory.mktemp("train_entry")
    root, logs = str(tmp / "kubric"), str(tmp / "logs")
    make_kubric_root(root)
    handler = signal.getsignal(signal.SIGUSR1)
    run_a = train.main(_args(root, logs, "--max_steps", "2"))
    trainer_a = run_a.pop("trainer")
    saved = copy.deepcopy(trainer_a.state_dict())
    data = apply_dotlist(load_config(TINY_CONFIG), _data(root))["data"]
    batch = batch_to_device(next(iter(instantiate_from_config(data).train_dataloader())), "cpu")
    next_a = _fixed_step(trainer_a, batch)

    run = train.setup(["--device", "cpu", "--resume", run_a["logdir"], "--max_steps", "4"])
    restored = copy.deepcopy(run.trainer.state_dict())
    resumed = train.setup(["--device", "cpu", "--resume", run_a["logdir"], "--max_steps", "4"])
    next_b = _fixed_step(resumed.trainer, batch)
    run_b = train.fit(run)
    return dict(root=root, logs=logs, run_a=run_a, run_b=run_b, saved=saved,
                restored=restored, next_a=next_a, next_b=next_b, handler=handler,
                file=restore_checkpoint(os.path.join(run_a["logdir"], "checkpoints"), 2))


def test_runs_write_the_csv_rows_and_checkpoints(runs):
    run_a, run_b = runs["run_a"], runs["run_b"]
    assert run_a["steps"] == [1, 2] and run_b["steps"] == [3, 4]
    assert run_b["start_step"] == 2 and run_b["global_step"] == 4
    assert all(np.isfinite(run_a["losses"] + run_b["losses"]))
    with open(os.path.join(run_a["logdir"], "metrics.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [1, 2, 3, 4]
    assert list(rows[0]) == ["step", "epoch", "loss", "grad_norm", "lr"]
    assert float(rows[0]["lr"]) == 1e-4
    ckptdir = os.path.join(run_a["logdir"], "checkpoints")
    assert sorted(os.listdir(ckptdir)) == ["step_2", "step_4"]
    assert latest_step(ckptdir) == 4
    assert [s["step"] for s in run_a["saves"] + run_b["saves"]] == [2, 4]
    assert len(os.listdir(os.path.join(run_a["logdir"], "configs"))) >= 1
    assert signal.getsignal(signal.SIGUSR1) == runs["handler"]


def test_checkpoint_is_the_trainer_state_bit_for_bit(runs):
    """Saved at step 2 = the trainer at step 2 = the trainer --resume builds."""
    saved, file = runs["saved"], runs["file"]
    assert file["global_step"] == 2 and runs["restored"]["global_step"] == 2
    assert _same_state(saved["masters"], file["masters"])
    assert _same_state(saved["optimizer"], file["optimizer"])
    assert _same_state(saved, runs["restored"])
    assert len(saved["optimizer"]["state"]) == len(saved["masters"]) > 0


def test_resumed_trainer_steps_as_the_saved_one(runs):
    loss_a, masters_a = runs["next_a"]
    loss_b, masters_b = runs["next_b"]
    assert loss_a == loss_b
    assert _same_state(masters_a, masters_b)


def test_image_log(runs):
    logs = runs["run_b"]["image_logs"]
    assert [im["step"] for im in logs] == [4] and not runs["run_a"]["image_logs"]
    prefix = logs[0]["prefix"]
    assert os.path.basename(prefix).startswith("gs-0000004_scn-0_fps-")
    with np.load(f"{prefix}_sample.npz") as z:
        frames = z["frames"]
    assert frames.shape == (T, 3 * H, W, 3)
    assert np.isfinite(frames).all() and frames.min() >= 0.0 and frames.max() <= 1.0
    import cv2  # the test host has it; the training machines need not

    strip = cv2.imread(f"{prefix}_strip.png")[..., ::-1]
    want = (np.clip(np.concatenate(list(frames), axis=1), 0, 1) * 255).astype(np.uint8)
    assert np.array_equal(strip, want)


def test_bundle_serves_a_training_checkpoint(runs, tmp_path):
    step_4 = os.path.join(runs["run_a"]["logdir"], "checkpoints", "step_4")
    bundle = load_model_bundle(TINY_CONFIG, step_4, num_steps=2, num_frames=T, device="cpu",
                               dtype=torch.float32)
    module = restore_checkpoint(os.path.dirname(step_4), 4)["module"]
    assert _same_state(dict(bundle.engine.state_dict()), dict(module))
    assert bundle.camera_control == "spherical" and bundle.model_name
    frames = np.random.default_rng(0).uniform(size=(T, H, W, 3))
    batch = construct_batch(frames, 30.0, 5.0, 0.0, T, 5, 127, 0.02, False, bundle)
    out = bundle.engine.sample_video(batch_to_device(batch, "cpu"),
                                     generator=torch.Generator().manual_seed(0))
    assert out["sampled_video"].shape == (T, H, W, 3)
    assert torch.isfinite(out["sampled_video"]).all()

    orbax = tmp_path / "checkpoints" / "step_7"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    for path in (orbax, orbax.parent):
        with pytest.raises(NotImplementedError, match="orbax"):
            load_model_bundle(TINY_CONFIG, str(path), device="cpu", dtype=torch.float32)


def test_interrupted_save_is_no_checkpoint(tmp_path):
    save_checkpoint(str(tmp_path), 3, {"global_step": 3})
    (tmp_path / ".step_9.tmp-123").mkdir()
    assert latest_step(str(tmp_path)) == 3
    assert restore_checkpoint(str(tmp_path))["global_step"] == 3


def test_exception_saves_a_checkpoint(runs, tmp_path):
    """melk: a step that raises leaves a checkpoint of the last step."""
    run = train.setup(_args(runs["root"], str(tmp_path), "--max_steps", "3"))

    def fail(*args, **kwargs):
        raise ValueError("step failed")

    run.trainer.train_step = fail
    with pytest.raises(ValueError, match="step failed"):
        train.fit(run)
    assert latest_step(run.ckptdir) == 0


def test_entry_needs_cuda_unless_cpu_is_asked_for(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["-b", TINY_CONFIG, "-l", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_sigusr1_saves_a_checkpoint_and_exits(runs, tmp_path):
    """melk on SIGUSR1: a checkpoint of the current step, then exit 1."""
    run = train.setup(_args(runs["root"], str(tmp_path), "--max_steps", "3"))
    step = run.trainer.train_step

    def signalled_step(*args, **kwargs):
        out = step(*args, **kwargs)
        os.kill(os.getpid(), signal.SIGUSR1)
        return out

    run.trainer.train_step = signalled_step
    with pytest.raises(SystemExit) as exc:
        train.fit(run)
    assert exc.value.code == 1 and latest_step(run.ckptdir) == 1
    assert signal.getsignal(signal.SIGUSR1) == runs["handler"]


def test_released_weights_scaled_lr_and_profile(runs, tmp_path):
    """--resume_from_checkpoint loads a released .ckpt through
    io/checkpoint.py's reader; --scale_lr multiplies the rate by the batch
    size (one device); --profile_steps writes a torch.profiler trace."""
    module = restore_checkpoint(os.path.join(runs["run_a"]["logdir"], "checkpoints"), 4)["module"]
    ckpt = str(tmp_path / "released.ckpt")
    torch.save({"state_dict": dict(module)}, ckpt)
    run = train.setup(_args(runs["root"], str(tmp_path / "logs"), "--max_steps", "4",
                            "--resume_from_checkpoint", ckpt, "--scale_lr",
                            "--profile_steps", "1"))
    assert _same_state(dict(run.trainer.engine.state_dict()), dict(module))
    assert run.lr == 2 * 1e-4 and run.start_step == 0
    result = train.fit(run)
    assert result["steps"] == [1, 2, 3, 4]
    assert os.path.isfile(os.path.join(run.logdir, "profile", "trace.json"))


def test_load_model_bundle_refuses_guidance_interval():
    """The bundle's sampler carries a guidance_interval (lo, hi), written
    into the config as scripts/eval_utils.py writes it; an interval whose lo
    exceeds its hi is refused by name."""
    bundle = load_model_bundle(TINY_CONFIG, device="cpu", guidance_interval=(0.2, 0.8))
    assert bundle.engine.sampler.guidance_interval == (0.2, 0.8)
    assert bundle.test_config["model"]["params"]["sampler_config"]["params"][
        "guidance_interval"] == [0.2, 0.8]
    assert load_model_bundle(TINY_CONFIG, device="cpu").engine.sampler.guidance_interval is None
    with pytest.raises(ValueError, match="lo must not exceed hi"):
        load_model_bundle(TINY_CONFIG, device="cpu", guidance_interval=(0.8, 0.2))


def test_bundle_camera_metadata_of_a_pardom_config():
    """A released PD config's camera fields: a fixed destination (control
    "none"), the gradual move of 13 frames."""
    cfg = load_config(os.path.join(os.path.dirname(TINY_CONFIG), os.pardir, "pretrained",
                                   "pardom_gradual_semantic.yaml"))
    meta = camera_metadata(cfg, cfg)
    assert meta["camera_control"] == "none" and meta["move_time"] == 13
    assert meta["trajectory"] == "interpol_sine" and meta["motion_bucket_range"] == [127, 127]
    assert cfg["data"]["params"]["output_modality"] == "segm"


def test_pr10_checkpoint_still_restores(runs, tmp_path):
    """A checkpoint of the first format (module, masters, optimizer,
    global_step; no update count, EMA, adapters or accumulation) resumes,
    and the resumed trainer steps as the saved one."""
    import shutil

    logdir = str(tmp_path / "pr10_run")
    shutil.copytree(os.path.join(runs["run_a"]["logdir"], "configs"),
                    os.path.join(logdir, "configs"))
    old = {k: v for k, v in runs["file"].items()
           if k in ("module", "masters", "optimizer", "global_step")}
    assert set(runs["file"]) - set(old) == {"updates"}
    save_checkpoint(os.path.join(logdir, "checkpoints"), 2, old)
    run = train.setup(["--device", "cpu", "--resume", logdir, "--max_steps", "4"])
    state = run.trainer.state_dict()
    assert state["global_step"] == 2 and state["updates"] == 2
    assert _same_state(state["masters"], runs["saved"]["masters"])
    data = apply_dotlist(load_config(TINY_CONFIG), _data(runs["root"]))["data"]
    batch = batch_to_device(next(iter(instantiate_from_config(data).train_dataloader())), "cpu")
    loss, masters = _fixed_step(run.trainer, batch)
    assert loss == runs["next_a"][0] and _same_state(masters, runs["next_a"][1])


def test_time_lora_ema_checkpoint_serves_through_the_bundle(runs, tmp_path):
    """A time_lora run with EMA: its checkpoint holds the adapters and the
    shadow under LitEma's names; load_model_bundle(support_ema=True) loads
    it with 0 missing keys, the UNet at the shadow with the adapters merged."""
    from gcd_tpu_torch.io.checkpoint import extract_ema_state_dict
    from gcd_tpu_torch.models.lora import merged_weight

    run = train.main(_args(runs["root"], str(tmp_path), "--max_steps", "2",
                           "model.params.ft_strategy=time_lora", "model.params.use_ema=true",
                           "lightning.callbacks.image_logger.params.disabled=true"))
    step_2 = os.path.join(run["logdir"], "checkpoints", "step_2")
    module = restore_checkpoint(os.path.dirname(step_2), 2)["module"]
    assert int(module["model_ema.num_updates"]) == 2
    heads = [k[:-len(".lora_a")] for k in module if k.endswith(".lora_a")]
    assert len(heads) == 108
    shadow = extract_ema_state_dict(module)
    bundle = load_model_bundle(TINY_CONFIG, step_2, support_ema=True, num_steps=2,
                               num_frames=T, device="cpu", dtype=torch.float32)
    assert bundle.engine.missing_keys == []
    got = dict(bundle.engine.state_dict())
    assert not any(k.endswith((".lora_a", ".lora_b")) for k in got)
    for head in heads:
        want = merged_weight(shadow[f"{head}.weight"], module[f"{head}.lora_a"],
                             module[f"{head}.lora_b"])
        assert torch.equal(got[f"{head}.weight"], want), head
    unet = [k for k in shadow if k[:-len(".weight")] not in heads]
    assert unet and all(torch.equal(got[k], shadow[k]) for k in unet)
    frames = np.random.default_rng(0).uniform(size=(T, H, W, 3))
    batch = construct_batch(frames, 30.0, 5.0, 0.0, T, 5, 127, 0.02, False, bundle)
    out = bundle.engine.sample_video(batch_to_device(batch, "cpu"),
                                     generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out["sampled_video"]).all()

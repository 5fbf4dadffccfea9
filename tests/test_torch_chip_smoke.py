"""chip_smoke.py's checks on the CPU: the training phase's `BlendWitness`,
which decides whether a blend factor's exactly-zero gradient at a step was
made by bf16 rounding (then the step may pass) or not (then it fails), K5's
expected launches from recorded GroupNorm sites (`split_calls`), the
training-entry phase's launch, state, image-log and CSV checks, and the
eval phase's frame check, sample recorder and guidance-interval split, and
the sharded phase's list of the served meshes' rank-local shapes against
the shapes the kernel phases hold, and the samplers phase's evaluation
counts on the flagship ladder.

A tiny rematerialised block blends x with x + scale * linear(x) in bf16,
as the UNet's VideoResBlock and SpatialVideoTransformer do.
"""

import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from gcd_tpu_torch.models.layers import AlphaBlender  # noqa: E402

B, T, N, C = 2, 3, 8, 16


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch = nn.Linear(C, C)
        self.time_mixer = AlphaBlender(0.5, "learned_with_images")

    def forward(self, x, ioi):
        alpha = self.time_mixer.get_alpha(ioi).reshape(-1)[:, None, None]
        return self.time_mixer(x, x + self.branch(x), alpha)


def _step(block, x):
    """One forward and backward with the block rematerialised; the witness's
    evidence for the block's blender, and its mix_factor gradient."""
    witness = chip_smoke.BlendWitness(block)
    block.zero_grad(set_to_none=True)
    ioi = torch.zeros(B, T)
    out = checkpoint(block, x, ioi, use_reentrant=False)
    weights = torch.linspace(-1.0, 1.0, out.numel()).reshape(out.shape)
    (out.float() * weights).sum().backward()
    witness.remove()
    return witness, block.time_mixer.mix_factor.grad


def _block(branch_scale: float) -> _Block:
    torch.manual_seed(0)
    block = _Block().to(torch.bfloat16)
    with torch.no_grad():
        block.branch.weight.mul_(branch_scale)
        block.branch.bias.mul_(branch_scale)
    return block


@pytest.mark.parametrize("branch_scale", [0.0, 1e-6])
def test_blend_witness_explains_a_zero_that_rounding_makes(branch_scale):
    """A temporal branch of zero, or one below bf16 resolution of x: the
    factor's gradient is exactly zero at every frame, and the fp32 sums show
    why."""
    x = torch.randn(B * T, N, C, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    witness, grad = _step(_block(branch_scale), x)
    assert witness.calls["time_mixer"] == 2  # the forward and the recompute
    assert float(grad.abs().sum()) == 0.0
    evidence = witness.explain("time_mixer")
    assert evidence["explained"]
    assert evidence["zero_frames"] == evidence["frames"] == B * T


def test_blend_witness_refuses_a_zero_that_rounding_cannot_make():
    """A live temporal branch: the gradient is not zero; were it read as zero
    at every frame, the fp32 sums would refuse it."""
    x = torch.randn(B * T, N, C, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    witness, grad = _step(_block(1.0), x)
    assert float(grad.abs().sum()) > 0.0
    assert witness.explain("time_mixer")["zero_frames"] == 0
    frames = witness.frames["time_mixer"]
    frames["grad"] = torch.zeros_like(frames["grad"])
    evidence = witness.explain("time_mixer")
    assert not evidence["explained"] and evidence["max_diff_over_slack"] > 1.0


@pytest.mark.parametrize("within", [True, False])
def test_blend_witness_weighs_frames_that_cancel(within):
    """A factor's zero from frames that read nonzero and cancel in the sum:
    explained when each frame's reading lies within its rounding slack of the
    fp32 difference, refused when one does not."""
    x = torch.randn(B * T, N, C, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    witness, _ = _step(_block(1e-6), x)
    frames = witness.frames["time_mixer"]
    grad = frames["grad"].clone().flatten()
    slack = frames["slack"].flatten()
    u = 0.5 * float(torch.minimum(slack[0], slack[1])) * (1.0 if within else 40.0)
    u = float(torch.tensor(u).to(torch.bfloat16))
    grad[0], grad[1] = u, -u
    frames["grad"] = grad.reshape(frames["grad"].shape)
    evidence = witness.explain("time_mixer")
    assert evidence["zero_frames"] == evidence["frames"] - 2
    assert evidence["explained"] == within


def test_blend_witness_refuses_cancelling_frames_that_rounding_resolves():
    """Two frames whose fp32 values lie far beyond their rounding slack, read
    exactly and of opposite sign, so that the factor's gradient sums to zero:
    a real cancellation of resolvable gradients, not rounding, so refused."""
    x = torch.randn(B * T, N, C, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    witness, _ = _step(_block(1e-6), x)
    frames = witness.frames["time_mixer"]
    grad = frames["grad"].clone().flatten()
    diff = frames["diff"].clone().flatten()
    slack = frames["slack"].flatten()
    u = 40.0 * float(torch.maximum(slack[0], slack[1]))
    u = float(torch.tensor(u).to(torch.bfloat16))
    grad[0], grad[1] = u, -u
    diff[0], diff[1] = u, -u
    frames["grad"] = grad.reshape(frames["grad"].shape)
    frames["diff"] = diff.reshape(frames["diff"].shape)
    evidence = witness.explain("time_mixer")
    assert evidence["max_reading_err_over_slack"] <= 1.0
    assert evidence["max_diff_over_slack"] > 1.0
    assert len(evidence["nonzero_frames"]) == 2
    assert not evidence["explained"]


def _view_layout(shape):
    """memory_layout's name for the (B, C, T, H, W) view of a (B, T, C, H, W)
    video."""
    b, c, t, h, w = shape
    return chip_smoke.memory_layout(torch.empty(b, t, c, h, w, device="meta").transpose(1, 2))


# Recorded GroupNorm sites -> calls: per-frame channels-last sites (K4's one
# pass), a time_stack view and a decoder plane (channels-last, split), and
# channels-first copies (contiguous: one pass up to 49152 values a group;
# the video view's groups are larger: split).
SITES = [(((28, 320, 32, 48), "channels_last", 1e-6, False), 150, False),
         (((28, 1280, 4, 6), "channels_last", 1e-6, False), 25, False),
         (((2, 320, 14, 32, 48), "channels_last", 1e-5, True), 250, True),
         (((14, 128, 256, 384), "channels_last", 1e-6, True), 10, True),
         (((28, 320, 32, 48), "contiguous", 1e-6, False), 3, False),
         (((2, 320, 14, 32, 48), _view_layout((2, 320, 14, 32, 48)), 1e-5, True), 4, True)]


@pytest.mark.parametrize("site,calls,split", SITES)
def test_site_tensor_has_the_recorded_layout(site, calls, split):
    shape, layout = site[:2]
    x = chip_smoke.site_tensor(shape, layout)
    assert tuple(x.shape) == shape and chip_smoke.memory_layout(x) == layout
    assert chip_smoke.split_calls(Counter({site: calls})) == (calls if split else 0)


def test_split_calls_count_the_split_variant_only():
    """K5 launches from K4 at the split sites alone: the one-pass sites (the
    UNet's per-frame GroupNorms) launch none."""
    sites = Counter({site: calls for site, calls, _ in SITES})
    assert chip_smoke.split_calls(sites) == 250 + 10 + 4


def test_every_channels_last_site_splits_at_the_plain_steps_batch():
    """A plain step of guidance_interval runs the UNet at B*T = 14, below
    K4's one-pass minimum of 16 samples: its per-frame sites split too."""
    for shape in ((14, 320, 32, 48), (14, 1280, 4, 6), (1, 320, 14, 32, 48)):
        assert chip_smoke.split_calls(Counter({(shape, "channels_last", 1e-6, False): 5})) == 5


# The training-entry phase's checks.
STEP = {"flash": 32, "flash_bwd": 16, "tattn": 32, "fused_mlp": 96, "fused_gn": 451,
        "gn_stats": 506, "fused_gn_conv": 88}


def test_per_step_launch_misses_name_the_steps_that_differ():
    short = dict(STEP, flash_bwd=15)
    assert chip_smoke.per_step_launch_misses([STEP, STEP], STEP) == []
    assert chip_smoke.per_step_launch_misses([STEP, short, STEP], STEP) == [(1, short)]


def test_checkpoint_bytes_counts_module_masters_and_adam():
    assert chip_smoke.checkpoint_bytes(10, 4) == 2 * 10 + 4 * 4 * 3


def test_state_mismatches_compare_bits():
    a = {"masters": {"w": torch.tensor([1.0, -0.0])}, "optimizer": {
        "state": {0: {"step": torch.tensor(3.0), "exp_avg": torch.ones(2)}},
        "param_groups": [{"lr": 1e-4, "betas": (0.9, 0.999), "params": [0]}]},
        "global_step": 4}
    assert chip_smoke.state_mismatches(a, chip_smoke.cpu_state(a)) == []
    b = chip_smoke.cpu_state(a)
    b["masters"]["w"] = torch.tensor([1.0, 0.0])  # equal values, other bits
    b["optimizer"]["state"][0]["exp_avg"] = torch.ones(2, dtype=torch.float64)
    b["optimizer"]["param_groups"][0]["lr"] = 2e-4
    b["global_step"] = 5
    assert chip_smoke.state_mismatches(a, b) == [
        ".masters.w", ".optimizer.state.0.exp_avg", ".optimizer.param_groups[0].lr",
        ".global_step"]
    nan = torch.tensor([float("nan")])
    assert chip_smoke.state_mismatches({"x": nan}, {"x": nan.clone()}) == []
    assert chip_smoke.state_mismatches(a, {"masters": {}}) == [": keys differ"]


def test_check_image_log_reads_what_the_image_logger_writes(tmp_path):
    from gcd_tpu_torch.engine.image_logger import write_png

    frames = np.random.default_rng(0).random((3, 12, 8, 3)).astype(np.float32)
    prefix = str(tmp_path / "gs-0000004")
    np.savez(f"{prefix}_sample.npz", frames=frames)
    write_png(f"{prefix}_strip.png", (frames[0] * 255).astype(np.uint8))
    assert chip_smoke.check_image_log(prefix) == {"frames_shape": [3, 12, 8, 3],
                                                  "strip_hw": [12, 8]}
    np.savez(f"{prefix}_sample.npz", frames=frames * 2.0)
    with pytest.raises(RuntimeError, match="not finite in"):
        chip_smoke.check_image_log(prefix)
    np.savez(f"{prefix}_sample.npz", frames=frames)
    (tmp_path / "gs-0000004_strip.png").write_bytes(b"not a png")
    with pytest.raises(RuntimeError, match="not a PNG"):
        chip_smoke.check_image_log(prefix)
    with pytest.raises(RuntimeError, match="missing"):
        chip_smoke.check_image_log(str(tmp_path / "gs-0000008"))


def test_csv_steps(tmp_path):
    path = tmp_path / "metrics.csv"
    path.write_text("step,epoch,loss,grad_norm,lr\n1,0,0.5,0.1,2e-05\n2,0,0.4,0.1,2e-05\n")
    assert chip_smoke.csv_steps(str(path)) == [1, 2]


def test_class_pixel_share_counts_the_pixels_the_loss_weighs():
    from gcd_tpu_torch.diffusion.loss import PERSON_RGB, VEHICLE_RGB

    jpg = np.full((2, 4, 5, 3), 0.9, np.float32)  # near no class colour
    jpg[0, 0, :2] = np.asarray(PERSON_RGB[1], np.float32) / 127.5 - 1.0
    jpg[1, 3, 4] = np.asarray(VEHICLE_RGB[-1], np.float32) / 127.5 - 1.0 + 0.015
    jpg[1, 2, 2] = np.asarray(VEHICLE_RGB[0], np.float32) / 127.5 - 1.0 + 0.025  # too far
    assert chip_smoke.class_pixel_share(jpg) == 3 / 40


# The eval phase's checks.
def test_check_frames_refuses_what_is_not_a_clip():
    frames = np.random.default_rng(1).random((3, 4, 5, 3)).astype(np.float32)
    chip_smoke.check_frames("x", frames, (3, 4, 5, 3))
    for bad, shape in ((frames, (3, 4, 6, 3)), (frames * 2.0, (3, 4, 5, 3)),
                       (np.where(frames > 0.5, np.nan, frames), (3, 4, 5, 3))):
        with pytest.raises(RuntimeError, match="not finite in"):
            chip_smoke.check_frames("x", bad, shape)


def test_recorded_samples_records_and_restores_the_sampler_factory():
    import types

    def make_sampler(bundle, decoding_t=14):
        return lambda batch, seed: {"sampled_video": np.full((2,), float(seed)),
                                    "cond_video": np.zeros(2)}

    module = types.SimpleNamespace(make_sampler=make_sampler)
    with chip_smoke.recorded_samples(module) as frames:
        sample = module.make_sampler(None, decoding_t=3)
        assert sample({}, 4)["sampled_video"].tolist() == [4.0, 4.0]
        sample({}, 5)
    assert module.make_sampler is make_sampler
    assert [f.tolist() for f in frames] == [[4.0, 4.0], [5.0, 5.0]]


def test_eval_interval_guides_13_of_the_flagship_steps():
    """guidance_interval (0.3, 100) on the 25-step ladder of sigma_max 700:
    13 guided steps, sigma 98.3 down to 0.339, and 12 plain ones."""
    from gcd_tpu_torch.utils.config import instantiate_from_config, load_config

    cfg = load_config(chip_smoke.CONFIG)["model"]["params"]["sampler_config"]
    cfg["params"]["guidance_interval"] = list(chip_smoke.EVAL_INTERVAL)
    sampler = instantiate_from_config(cfg)
    guided = sampler.guided_steps()
    sigmas = sampler.sigmas()[:-1][guided]
    assert len(guided) == 25 and sum(guided) == 13
    assert guided == [False] * 7 + [True] * 13 + [False] * 5
    assert round(float(sigmas[0]), 1) == 98.3 and round(float(sigmas[-1]), 3) == 0.339


def test_served_mesh_shapes_are_held():
    """Every rank-local shape of the served meshes (the served pair on one
    card: 56 UNet rows, 28 conditioner frames; data 2: 28 rows, 14 frames;
    data 2 x fsdp 2: 14 rows, one video, F = 1; fsdp 2 x tensor 2: 28 rows
    TP-local; a decode chunk of 14 frames) is among the held cases."""
    shapes = {name: chip_smoke.served_mesh_shapes(*mesh)
              for name, mesh in chip_smoke.SERVED_MESHES.items()}
    assert shapes["one"] == {("unet", 56, 1, 1), ("conditioner", 28, 1, 1),
                             ("decode", 14, 1, 1)}
    assert shapes["data2"] == {("unet", 28, 1, 1), ("conditioner", 14, 1, 1),
                               ("decode", 14, 1, 1)}
    assert ("unet", 14, 1, 1) in shapes["data2_fsdp2"]
    assert ("unet", 28, 2, 1) in shapes["fsdp2_tensor2"]
    held = chip_smoke.held_shapes()
    assert all(v <= held for v in shapes.values())
    # Not held: tensor 4 on one batch rank (56 rows TP-local), a decode chunk
    # of 7 frames.
    assert not chip_smoke.served_mesh_shapes(1, 1, 4) <= held
    assert not chip_smoke.served_mesh_shapes(2, 1, 1, decoding_t=7) <= held


def test_samplers_phase_plans():
    """The samplers phase's (a) runs on the flagship's 25-step ladder:
    Heun and DPM++ 2S evaluate 49 times (no second evaluation on the final
    step), the others 25; EDMSampler churns some of the steps but not all;
    the ancestral and churned samplers need per-step noise."""
    import copy

    from gcd_tpu_torch.utils.config import instantiate_from_config, load_config

    base = load_config(chip_smoke.CONFIG)["model"]["params"]["sampler_config"]
    evaluations = {}
    for name, extra in chip_smoke.SAMPLER_RUNS:
        cfg = copy.deepcopy(base)
        cfg["target"] = chip_smoke.SAMPLING + name
        cfg["params"].update(extra)
        sampler = instantiate_from_config(cfg)
        plan = sampler.plan(sampler.sigmas())
        evaluations[name] = sum(len(p["evals"]) for p in plan)
        assert sampler.needs_step_noise == (name in ("EDMSampler", "EulerAncestralSampler",
                                                     "DPMPP2SAncestralSampler"))
        if name == "EDMSampler":
            assert 0 < sum(p["bump"] > 0 for p in plan) < len(plan)
    assert evaluations == {"EDMSampler": 25, "HeunEDMSampler": 49, "EulerAncestralSampler": 25,
                           "DPMPP2SAncestralSampler": 49, "DPMPP2MSampler": 25,
                           "LinearMultistepSampler": 25}
    assert set(chip_smoke.PROFILED_RUNS) <= set(evaluations) | {"IdentityGuider", "VanillaCFG"}

"""The reference against the program at a tiny size in float32 on the CPU:
the same key space, the same sampled clip, the same loss; and the control
(the reference in float8) well apart from both."""

import pytest
import torch

from gcd_bench.control import make_run, readings
from gcd_bench.harness import ROOT, build_reference, latent_noise, load_json, random_clips
from gcd_bench.tests.test_bench_runs import TINY


def program_engine(config):
    from gcd_tpu_torch.engine.build import engine_from_config

    return engine_from_config(config["model"], device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("name", ["kubric", "pardom"])
def test_reference_matches_program(name):
    torch.manual_seed(0)
    config = load_json(TINY[name])
    engine = program_engine(config)
    sd = engine.state_dict()
    ref = build_reference(config["model"], {k: v.clone() for k, v in sd.items()})
    t, hw = config["frames"], (config["height"], config["width"])
    gen = torch.Generator().manual_seed(5)
    batch = random_clips(gen, 1, t, hw, torch.device("cpu"), target=True)
    noise = latent_noise(11, t, hw, torch.device("cpu"))
    got = engine.sample_video(batch, noise=noise)["sampled_video"]
    want = ref.sample(batch, noise)
    assert torch.allclose(got, want, atol=1e-5)
    from gcd_bench.drivers.train import draws_for
    from gcd_bench.harness import Run

    run = Run("x", {}, config, {}, {}, 0, 0.0, False, torch.device("cpu"), torch.float32)
    draws = draws_for(run, gen, t)
    engine.train()
    for step in (0, 1):
        lp = engine.loss(batch, step, draws=draws).mean()
        lr = ref.loss(batch, draws, step)
        assert float(lp.detach()) == pytest.approx(float(lr.detach()), rel=1e-5)


@pytest.mark.parametrize("cell, name", [("kubric.clip_b1", "frames_gap"),
                                        ("pardom.train_b2", "loss_gap")])
def test_control_reads_far_above_the_program(cell, name):
    from gcd_bench.tests.test_bench_runs import tiny_run

    config = load_json(TINY["pardom" if cell.startswith("pardom") else "kubric"])
    control = readings(make_run(cell, 3, "cpu", torch.float32, config))["control"]
    _, result = tiny_run(cell, seed=3)
    assert control[name] > 5 * result["checks"][name]["value"]


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  load_json(ROOT / "BENCHMARK.json")["workloads"]])
def test_control_fails_the_limits_on_the_card(card, cell):
    """The control at the cell's own size, and each fault a training cell
    can have: some compared number over its limit."""
    for seed in (101, 102, 103):
        run = make_run(cell, seed)
        for what, got in readings(run).items():
            assert any(got[k] > lim for k, lim in run.limits.items()), (seed, what, got)

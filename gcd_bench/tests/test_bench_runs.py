"""Whole runs of each cell at a tiny size on the CPU (the program in
float32, the card's look skipped): the result line's form, `correct` true
on the sound program, and `correct` false with each fault a cell can have
planted in the program underneath: an answer altered where it is produced;
a step that leaves the state unchanged; half of the batch left out of the
loss, the mean taken over the rest. (The exchange between cards is
left out of no cell: every cell runs on one card.)"""

import json
import math

import pytest
import torch

from gcd_bench.harness import ROOT, load_json
from gcd_bench.run import execute
from gcd_bench.tests.test_bench_contract import NAME, UNIT

TINY = {"kubric": ROOT / "gcd_bench" / "tests" / "tiny_kubric.json",
        "pardom": ROOT / "gcd_bench" / "tests" / "tiny_pardom.json"}
CELLS = {w["name"]: w["config"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]}


def tiny_run(cell, trace=False, seed=2 ** 40 + 3):
    torch.set_num_threads(2)
    return execute(cell, seed, 0.5, trace, device="cpu", dtype=torch.float32,
                   config=load_json(TINY[CELLS[cell]]))


def assert_result_line(result, trace):
    line = json.dumps(result)
    assert "\n" not in line
    back = json.loads(line)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(back)[-1] == "checks"
    assert isinstance(back["correct"], bool) and back["attempted"] > 0 and back["failed"] == 0
    for name, m in back["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"]) and math.isfinite(m["value"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(back["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(back["device"])
        assert set(back["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in back["checks"].items():
        assert NAME.match(name) and set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct(cell, trace):
    run, result = tiny_run(cell, trace)
    assert_result_line(result, trace)
    assert result["correct"], result["checks"]
    if not trace:
        assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2


@pytest.mark.parametrize("cell", ["kubric.serve_b2", "kubric.clip_b1"])
def test_altered_answer_is_not_correct(monkeypatch, cell):
    from gcd_tpu_torch.engine.engine import DiffusionEngine

    original = DiffusionEngine.sample_video

    def altered(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        out["sampled_video"] = (out["sampled_video"] + 0.05).clamp(0.0, 1.0)
        return out

    monkeypatch.setattr(DiffusionEngine, "sample_video", altered)
    _, result = tiny_run(cell)
    assert result["correct"] is False
    assert result["checks"]["frames_gap"]["value"] > result["checks"]["frames_gap"]["limit"]


def test_unchanged_state_is_not_correct(monkeypatch):
    from gcd_tpu_torch.engine import trainer as trainer_mod

    original = trainer_mod.Trainer.__init__

    def frozen(self, *args, **kwargs):
        original(self, *args, **kwargs)
        self.optimizer.step = lambda *a, **k: None

    monkeypatch.setattr(trainer_mod.Trainer, "__init__", frozen)
    _, result = tiny_run("pardom.train_b2")
    assert result["correct"] is False
    assert result["checks"]["change_gap.median"]["value"] >= 0.99


def test_half_batch_is_not_correct(monkeypatch):
    from gcd_tpu_torch.engine.engine import DiffusionEngine

    original = DiffusionEngine.loss

    def half(self, *args, **kwargs):
        per_sample = original(self, *args, **kwargs)
        return per_sample[: per_sample.shape[0] // 2]

    monkeypatch.setattr(DiffusionEngine, "loss", half)
    _, result = tiny_run("pardom.train_b2")
    assert result["correct"] is False

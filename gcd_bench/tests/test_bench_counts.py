"""The yardstick's arithmetic against hand counts at tiny shapes: each
gcd:: op's operations and bytes, the model FLOP counter, the union of
kernel intervals, the per-leaf gaps."""

import math

import pytest
import torch
from torch import nn

from gcd_bench import ops, profile
from gcd_bench.drivers.train import leaf_gaps
from gcd_bench.flops import _count
from gcd_bench.harness import frames_gap, percentile

BF16, F32 = "c10::BFloat16", "float"


def count(op, shapes, dtypes=None, scalars=None, frames=14):
    return ops.counter(op)(shapes, dtypes, scalars, frames)


def test_flash_attention():
    # q, k, v (2, 6, 8): q k^T 2*2*6*6*8, p v the same; 4 tensors of 96 bf16 values.
    assert count("flash_attention", [[2, 6, 8], [2, 6, 8], [2, 6, 8], [], []]) == (
        2 * (2 * 2 * 6 * 6 * 8), 4 * 96 * 2)


def test_flash_attention_bwd():
    shapes = [[2, 6, 8]] * 4 + [[], []]
    assert count("flash_attention_bwd", shapes) == (4 * (2 * 2 * 6 * 6 * 8), 7 * 96 * 2)


def test_temporal_attention_frames_from_the_call_or_the_clip():
    shapes = [[6, 5, 8]] * 3 + [[], [], []]
    # B*T = 6 rows of T = 3 frames: each of 6 * 5 queries meets 3 keys over 8 channels.
    want = (2 * 2 * 6 * 5 * 3 * 8, 4 * 240 * 2)
    assert count("temporal_attention", shapes, scalars=["", "", "", "3", "1", ""]) == want
    assert count("temporal_attention", shapes, frames=3) == want


def test_geglu_mlp():
    # x (2, 3, 4) -> up (16 = 2 x 8) -> down (8 -> 4)
    shapes = [[2, 3, 4], [16, 4], [16], [4, 8], [4]]
    flops = 2 * 6 * 4 * 16 + 2 * 6 * 8 * 4
    nbytes = 2 * (24 + 64 + 16 + 32 + 4 + 24)
    assert count("geglu_mlp", shapes, [BF16] * 5) == (flops, nbytes)


def test_gn_silu_conv3x3_and_group_norms():
    shapes = [[2, 4, 5, 6], [4], [4], [8, 4, 3, 3], [8], [], [], [], []]
    flops = 2 * 2 * 5 * 6 * 8 * 4 * 9
    nbytes = 2 * (240 + 4 + 4 + 288 + 8) + 2 * (2 * 8 * 5 * 6)
    assert count("gn_silu_conv3x3", shapes) == (flops, nbytes)
    x = [[2, 64, 3, 3], [64], [64], [], [], [], []]
    assert count("group_norm", x, [BF16, F32, F32]) == (8 * 1152, 2 * 1152 * 2 + 2 * 64 * 4)
    assert count("group_stats", [[2, 64, 3, 3], []], scalars=["", "32"]) == (
        2 * 1152, 1152 * 2 + 2 * 2 * 32 * 4)


def test_op_without_a_counter_is_left_out():
    assert ops.counter("no_such_op") is None


def test_model_flops_counter():
    lin, conv = nn.Linear(8, 16).to("meta"), nn.Conv2d(3, 4, 3, padding=1).to("meta")
    x = torch.empty(5, 8, device="meta")
    img = torch.empty(2, 3, 6, 6, device="meta")
    assert _count(lambda: lin(x)) == 2 * 5 * 8 * 16
    assert _count(lambda: conv(img)) == 2 * 2 * 6 * 6 * 4 * 3 * 9


def test_union_of_kernel_intervals():
    spans = profile.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)])
    assert spans == [(0, 3), (5, 6)] and sum(b - a for a, b in spans) == 4


def test_leaf_gaps_measured_against_leaf_or_median():
    want = {"a": 1.0, "b": 2.0, "c": 4.0}
    got = {"a": 1.5, "b": 2.0, "c": 4.4}
    # a: 0.5 over max(1, median 2) = 0.25; c: 0.4 / 4 = 0.1
    assert leaf_gaps(got, want, ["a", "b", "c"]) == pytest.approx(0.25)


def test_frames_gap_and_percentile():
    e = torch.tensor([0.0, 1.0, 2.0, 3.0])
    assert frames_gap(e + 0.1, e) == pytest.approx(math.sqrt(4 * 0.01) / math.sqrt(5.0))
    assert percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == pytest.approx(3.0)


def test_host_slice_records_gcd_ops_with_shapes():
    from gcd_tpu_torch.ops.fused_mlp import geglu_mlp

    x = torch.randn(6, 4)
    w1, b1, w2, b2 = torch.randn(16, 4), torch.randn(16), torch.randn(4, 8), torch.randn(4)
    slices = profile.Slices()
    profile.host_slice(slices, lambda: geglu_mlp(x, w1, b1, w2, b2))
    calls = [c for c in slices.ops if c.name == "geglu_mlp"]
    assert calls and [list(s) for s in calls[0].shapes[:4]] == [[6, 4], [16, 4], [16], [4, 8]]

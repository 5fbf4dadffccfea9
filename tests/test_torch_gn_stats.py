"""K5 on channels-last tensors (csrc/fused_norm.cu, group_stats_cl_kernel) on
the CPU: its partition constants pinned to the source, and a model of its
summation order held against the JAX package's K5 (`group_stats_pallas`
with its `_INTERPRET` switch) and against the plain versions.

The model sums as the kernel does: per channel, each pixel lane's pixels in
order; per thread (8 channels of one lane), its channels in order into the
sums of the (at most two) groups they touch; per group, the block's thread
sums by `sub` lanes, lane j taking pixel lanes j, j + sub, ... and each
one's vectors in order, combined by a butterfly; a cluster's block sums in
block order; a sample's cluster partials (when it has more than one
cluster) as `sub`-way strided sums combined by a butterfly. fp32 throughout; the sums differ from JAX's and the plain
version's only in order, ~1e-7 relative, against a bound of 1e-5
(tests/test_torch_fused_norm.py's).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.ops import fused_norm as jfn
from gcd_tpu_torch.ops.fused_norm import (
    STATS_BLOCKS,
    STATS_CLUSTER,
    STATS_CLUSTER_FROM,
    STATS_MAX_THREADS,
    STATS_THREADS,
    STATS_UNROLL,
    TICKETS,
    ClStatsPlan,
    cl_stats_plan,
    group_scale_shift_plain,
    group_stats_plain,
)
from tests.torch_port_helpers import rel_l2
from tests.torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(__file__).resolve().parent.parent / "gcd_tpu_torch" / "csrc" / "fused_norm.cu"
CONSTS = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", CSRC.read_text())}
TOL = 1e-5
G = 32


@pytest.fixture
def interpret_stats():
    jfn._INTERPRET = True
    yield
    jfn._INTERPRET = False


def _sub(groups: int, threads: int) -> int:
    """csrc/fused_norm.cu's cl_sub: lanes adding one group's sums."""
    sub = CONSTS["CL_SUB"]
    while sub > 1 and sub * groups > threads // 32 * 32:
        sub //= 2
    return sub


def _butterfly(vals):
    """Every lane's sum after xor-shuffle steps 1, 2, 4, ...: lane 0's."""
    o = 1
    while o < len(vals):
        vals = [vals[j] + vals[j ^ o] for j in range(len(vals))]
        o *= 2
    return vals[0]


def _strided(terms, sub):
    """Lane j of `sub` adds terms j, j + sub, ... in order; then the
    butterfly."""
    vals = []
    for j in range(sub):
        t = torch.zeros_like(terms[0])
        for k in range(j, len(terms), sub):
            t = t + terms[k]
        vals.append(t)
    return _butterfly(vals)


def cl_stats_model(x: torch.Tensor, groups: int, plan: ClStatsPlan):
    """(s1, s2), each (N, G), of a channels-last (N, P, C) fp32 tensor, in
    the channels-last K5's order of summation under `plan`."""
    n, p, c = x.shape
    cpg = c // groups
    span = plan.per * plan.rows
    sub = _sub(groups, plan.threads)
    partials = []
    for b in range(plan.blocks):
        lo, hi = b * span, min(p, (b + 1) * span)
        # Lane l's pixels lo + l + i * lanes, i = 0, 1, ..., below hi, in order i.
        lane_sum = torch.zeros(n, plan.lanes, c)
        lane_sq = torch.zeros(n, plan.lanes, c)
        for i in range(max(0, -(-(hi - lo) // plan.lanes))):
            pix = lo + torch.arange(plan.lanes) + i * plan.lanes
            ok = (pix < hi).float()[None, :, None]
            v = x[:, pix.clamp(max=p - 1)] * ok
            lane_sum = lane_sum + v
            lane_sq = lane_sq + v * v
        ch = torch.stack((lane_sum, lane_sq), dim=-1).reshape(n, plan.lanes, plan.vpr, 8, 2)
        # Each thread's two group sums: channels before `split` and after.
        two = torch.zeros(n, plan.lanes, plan.vpr, 2, 2)
        for v in range(plan.vpr):
            split = min(8, (8 * v // cpg + 1) * cpg - 8 * v)
            for i in range(8):
                two[:, :, v, int(i >= split)] = two[:, :, v, int(i >= split)] + ch[:, :, v, i]
        block = []
        for g in range(groups):
            c0 = g * cpg
            vecs = range(c0 // 8, (c0 + cpg - 1) // 8 + 1)
            lanes = []
            for j in range(sub):
                t = torch.zeros(n, 2)
                for lane in range(j, plan.lanes, sub):
                    for v in vecs:
                        t = t + two[:, lane, v, 0 if 8 * v >= c0 else 1]
                lanes.append(t)
            block.append(_butterfly(lanes))
        partials.append(torch.stack(block, dim=1))
    clusters = []
    for k in range(plan.clusters):
        t = partials[k * plan.cluster]
        if plan.cluster > 1:
            t = torch.zeros_like(t)
            for b in range(k * plan.cluster, (k + 1) * plan.cluster):
                t = t + partials[b]
        clusters.append(t)
    total = clusters[0] if plan.clusters == 1 else _strided(clusters, sub)
    return total[..., 0], total[..., 1]


def _channels_last(shape, seed):
    rng = np.random.default_rng(seed)
    return (0.5 + 2.0 * rng.normal(size=shape)).astype(np.float32)


def test_partition_constants_match_the_kernel():
    names = ("CL_THREADS", "CL_MAX_THREADS", "CL_UNROLL", "CL_BLOCKS", "CL_CLUSTER",
             "CL_CLUSTER_FROM", "TICKETS")
    assert {k: CONSTS[k] for k in names} == dict(zip(names, (
        STATS_THREADS, STATS_MAX_THREADS, STATS_UNROLL, STATS_BLOCKS, STATS_CLUSTER,
        STATS_CLUSTER_FROM, TICKETS)))


# (N, P, C) -> (lanes, rows, chunks a block, blocks a cluster, clusters a
# sample): the UNet's ds1 and 4 x 6 sites, the decoder's full-resolution
# plane and its time_stack view (one sample of 14 frames), and the UNet's
# widest input (ds4's skip concat).
PLANS = [((28, 1536, 320), (6, 48, 2, 1, 16)), ((28, 24, 1280), (1, 8, 1, 1, 3)),
         ((14, 98304, 128), (16, 128, 22, 1, 35)), ((1, 1376256, 128), (16, 128, 21, 8, 64)),
         ((28, 96, 2560), (1, 8, 1, 1, 12))]


@pytest.mark.parametrize("shape,want", PLANS)
def test_plan_keeps_a_call_near_its_block_budget(shape, want):
    n, p, c = shape
    plan = cl_stats_plan(n, c, p)
    assert (plan.lanes, plan.rows, plan.per, plan.cluster, plan.clusters) == want
    assert plan.threads == plan.vpr * plan.lanes <= max(STATS_THREADS, plan.vpr)
    used = -(-p // (plan.per * plan.rows))  # blocks with pixels; the rest are empty
    assert n * used <= max(STATS_BLOCKS, n)
    assert plan.blocks == plan.cluster * plan.clusters and 0 <= plan.blocks - used < plan.cluster
    assert plan.cluster == (STATS_CLUSTER if used >= STATS_CLUSTER_FROM else 1)


# Channels-last (N, P, C): several blocks a sample, C / G = 4 (every 8-channel
# vector touches two groups); C / G = 10, so some vectors straddle two
# groups; one block a sample.
@pytest.mark.parametrize("shape", [(2, 1280, 128), (2, 1536, 320), (3, 24, 128)])
def test_cl_model_matches_tpu_stats_kernel(shape, interpret_stats):
    x = _channels_last(shape, 1)
    n, p, c = shape
    s1, s2 = cl_stats_model(torch.from_numpy(x), G, cl_stats_plan(n, c, p))
    j1, j2 = jfn.group_stats_pallas(jnp.asarray(x), G)
    assert s1.shape == s2.shape == (n, G)
    assert rel_l2(s1.numpy(), np.asarray(j1)) <= TOL
    assert rel_l2(s2.numpy(), np.asarray(j2)) <= TOL


def test_cl_model_with_several_chunks_a_block():
    """Blocks that take more than one chunk (the large planes) and clusters
    (the samples of many blocks): the model against the plain version, with
    a plan of 2 chunks a block, three blocks with pixels and an empty
    fourth, in two clusters of two."""
    n, p, c = 2, 640, 128
    x = torch.from_numpy(_channels_last((n, p, c), 2))
    base = cl_stats_plan(n, c, p)
    plan = base._replace(per=2, cluster=2, clusters=2, blocks=4)
    assert -(-p // (2 * base.rows)) == 3
    s1, s2 = cl_stats_model(x, G, plan)
    r1, r2 = group_stats_plain(x.permute(0, 2, 1), G)
    assert rel_l2(s1.numpy(), r1.numpy()) <= TOL
    assert rel_l2(s2.numpy(), r2.numpy()) <= TOL


def test_scale_shift_table_from_model_sums():
    """K7's (scale, shift) table as the kernel's last block forms it from its
    sums (mean = s1 / n, inv = rsqrt(max(s2 / n - mean^2, 0) + eps)) matches
    group_scale_shift_plain."""
    n, p, c, eps = 2, 1536, 320, 1e-5
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_channels_last((n, p, c), 3))
    gamma = torch.from_numpy((1.0 + 0.1 * rng.normal(size=c)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.normal(size=c)).astype(np.float32))
    s1, s2 = cl_stats_model(x, G, cl_stats_plan(n, c, p))
    count = p * (c // G)
    mean = s1 / count
    inv = torch.rsqrt((s2 / count - mean * mean).clamp_min(0.0) + eps)
    scale = inv.repeat_interleave(c // G, 1) * gamma
    table = torch.stack((scale, beta - mean.repeat_interleave(c // G, 1) * scale), dim=-1)
    want = group_scale_shift_plain(x.permute(0, 2, 1), gamma, beta, G, eps)
    assert table.shape == want.shape == (n, c, 2)
    assert rel_l2(table.numpy(), want.numpy()) <= TOL

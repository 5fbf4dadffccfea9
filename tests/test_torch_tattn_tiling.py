"""K2 (csrc/temporal_attention.cu) on the CPU: a torch model of its tiling
held against the JAX package's Pallas kernel (`_kernel` through
`_pallas_fwd`, in interpret mode) and against its XLA formulation
(`_xla_temporal`), its persistent schedule pinned to the source and
checked, and its tile constants pinned to the source; and a model of its
general family (any T, any D up to 1024) held against the same three.

The model computes as the kernel does, in fp32 on bf16 values:
  - one unit per (video b, position s, head h), in the kernel's order (head
    fastest, then position, then video); the kernel's tile along the
    positions is one position, so no tile is ragged along S: any S works,
    and the tests take S of 5 and 37, which no tile of 8 positions divides;
  - per tensor, the TMA box (64 channels x 16 MT frames) at channel h D of
    the (C, S, T, B) view: frames past T and channels past C read as zero,
    T padded to MT row tiles of 16 rows (MT = 1 up to T = 16, 2 from 17 to
    32, the narrow family's tall units); a head slab is the box's first D
    channels (D / 64 boxes at D > 64: two at 128, four at 256, eight at 512
    in the wide family, whose per-value arithmetic is the narrow family's);
  - S = Q K^T as a 16 MT x 16 MT tile (MT query strips of 16 rows against
    every key row), times the scale; key columns >= T set to -inf before
    the row max; P = exp(s - max) in fp32 and its fp32 row sum; P rounded
    to bf16 before PV; O = P V divided by the sum after PV;
  - the stores: frames t < T of each unit written at ((b T + t) S + s) C +
    h D into an output that starts as NaN, so a unit never stored, or a
    padded row stored, would show.

Tolerances, and why:
  - against `_xla_temporal` in fp32 with the model's P left unrounded:
    the same function, sums in another order, ~1e-7 relative L2; bound
    1e-5. This checks the boxes, padding, masks and store offsets at every
    shape.
  - against `_kernel` on bf16 inputs (interpret mode): the same rounding
    points; the fp32 sums differ in order, so a P or an output value within
    an fp32 ulp of a bf16 rounding boundary can round the other way:
    measured 0 to 1.1e-4 relative L2 over six seeds at the tested shape;
    bound 5e-4. With the model's P left unrounded the same comparison reads
    1.9e-3 to 2.1e-3, above 1e-3, so the bound sees where P is rounded. At T
    = 25 and 32 (two row tiles) the same comparison read 0 to 8.2e-5 over
    six seeds, 2.1e-3 to 2.2e-3 with P unrounded: the same bound.

The general family's model (`k2_general_model`) tiles as that kernel does:
no TMA box (cp.async or 2-byte copies), D padded with zero channels to the
next multiple of 16 and T with zero frames to strips of 16; per query
strip, the key tiles of 16 streamed twice: pass 0 for the row maxima,
then, for each chunk of O's channels (all of them up to DP = 128, else 64
at a time), P = exp(s - max) against the final max, the row sums of the
unrounded P tile by tile, P rounded to bf16, O += P V; O / sum stored at
frames < T and channels < D. Against `_xla_temporal` in fp32 (P
unrounded): 1e-5, as above. Against `_kernel` in interpret mode at T = 40
and 64 (D = 64): 3.9e-5 to 9.6e-5 over three seeds each, 2.1e-3 to 2.2e-3
with P unrounded: the same 5e-4 bound. Against `_xla_temporal` on bf16
inputs at D = 40 and 160 (JAX's route for them): `BF16_XLA_TOL`.
"""

import math
import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from gcd_tpu.ops.temporal_attention import _pallas_fwd, _xla_temporal
from gcd_tpu_torch.ops.temporal_attention import (
    MAX_FRAMES,
    MAX_GENERAL_HEAD_DIM,
    MAX_HEAD_DIM,
    MAX_WIDE_FRAMES,
    MAX_WIDE_HEAD_DIM,
    kernel_family,
    kernel_takes,
)
from tests.torch_port_helpers import rel_l2
from tests.torch_threads import one_torch_thread  # noqa: F401

CSRC = (Path(__file__).resolve().parent.parent / "gcd_tpu_torch" / "csrc"
        / "temporal_attention.cu")
CONSTS = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", CSRC.read_text())}
ROWS, WARPS, STAGES = CONSTS["ROWS"], CONSTS["WARPS"], CONSTS["STAGES"]
MAX_ROW_TILES = CONSTS["MAX_ROW_TILES"]
WIDE_WARPS, WIDE_STAGES = CONSTS["WIDE_WARPS"], CONSTS["WIDE_STAGES"]
GEN_MAX_D, GEN_CHUNK, GEN_PAD = CONSTS["GEN_MAX_D"], CONSTS["GEN_CHUNK"], CONSTS["GEN_PAD"]
GEN_WARPS, GEN_SM_WARPS = CONSTS["GEN_WARPS"], CONSTS["GEN_SM_WARPS"]
GEN_STAGES, GEN_MAX_SMEM = CONSTS["GEN_STAGES"], CONSTS["GEN_MAX_SMEM"]
BOX_CHANNELS = 64  # a box's inner extent: 128 bytes of bf16, the swizzle span
XLA_TOL = 1e-5
KERNEL_TOL = 5e-4


def _bf16(z: torch.Tensor) -> torch.Tensor:
    return z.to(torch.bfloat16).float()


def row_tiles(t: int) -> int:
    """The row tiles of 16 frames a unit of T = t frames is padded to (the
    C entry's `T <= ROWS ? launch<KC, 1> : launch<KC, 2>`)."""
    return 1 if t <= ROWS else 2


def k2_model(q3, k3, v3, t: int, heads: int, scale: float, round_p: bool = True):
    """fp32 (B*T, S, C) out of fp32 (B*T, S, C) q, k, v, as K2 tiles it;
    the output before its final rounding to bf16."""
    bt, s, c = q3.shape
    b, d = bt // t, c // heads
    dc = -(-d // BOX_CHANNELS)
    rows = ROWS * row_tiles(t)
    u = torch.arange(b * s * heads)
    h, pos, vid = u % heads, (u // heads) % s, u // (heads * s)
    frames = torch.arange(rows)

    def slabs(z):
        # The (C, S, T, B) map's zero fill: channels past C, frames past T.
        x = F.pad(z.reshape(b, t, s, c), (0, BOX_CHANNELS * dc, 0, 0, 0, rows - t))
        ch = h[:, None] * d + torch.arange(BOX_CHANNELS * dc)[None]
        box = x[vid[:, None, None], frames[None, :, None], pos[:, None, None], ch[:, None, :]]
        return box[..., :d]  # (units, 16 MT, D)

    qs, ks, vs = slabs(q3), slabs(k3), slabs(v3)
    sc = (qs @ ks.transpose(1, 2)) * scale
    sc = sc.masked_fill(frames >= t, -math.inf)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True)
    o = ((_bf16(p) if round_p else p) @ vs) / denom
    out = torch.full((bt * s * c,), math.nan)
    offset = (((vid[:, None, None] * t + torch.arange(t)[None, :, None]) * s
               + pos[:, None, None]) * c + h[:, None, None] * d
              + torch.arange(d)[None, None, :])
    out[offset.flatten()] = o[:, :t].flatten()
    return out.reshape(bt, s, c)


def _inputs(bt, s, c, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(bt, s, c)).astype(np.float32)).to(
        torch.bfloat16).float() for _ in range(3)]


def test_constants_match_the_kernel():
    """The model's padding and the wrapper's domain are the source's: the
    narrow family takes T <= 32 in one or two row tiles, the wide family T
    <= 16 in one, the general family every other shape up to D = 1024."""
    src = CSRC.read_text()
    assert ROWS == MAX_WIDE_FRAMES == 16 and MAX_ROW_TILES * ROWS == MAX_FRAMES == 32
    assert re.search(r"const uint32_t box\[4\] = \{64, 1, \(uint32_t\)\(MT \* ROWS\), 1\};",
                     src)
    assert re.search(r"return T <= ROWS \? launch<KC, 1>\(.*\)\s*: launch<KC, 2>\(", src)
    flat = " ".join(src.split())
    assert re.search(r"if \(D > 128 && D <= 512 && D % 64 == 0 && T <= ROWS\) \{ "
                     r"switch \(D / 64\)", flat)
    assert re.search(r"if \(D <= 128 && D % 16 == 0 && T <= MAX_ROW_TILES \* ROWS\) \{ "
                     r"switch \(D / 16\)", flat)
    assert re.search(r"if \(D > GEN_MAX_D\) return \(int\)cudaErrorInvalidValue; "
                     r"return C % 8 == 0 && D % 8 == 0 \? launch_general_vec<true>", flat)
    assert MAX_WIDE_HEAD_DIM == 512 and MAX_HEAD_DIM == 128
    assert MAX_GENERAL_HEAD_DIM == GEN_MAX_D == 1024
    families = {d: [t for t in range(1, 40) if kernel_family(t, d) == "narrow"]
                for d in range(1, 130)}
    assert [d for d, ts in families.items() if ts] == list(range(16, MAX_HEAD_DIM + 1, 16))
    assert all(families[d] == list(range(1, 33)) for d in range(16, 129, 16))
    assert [d for d in range(1, 1100) if kernel_family(16, d) == "wide"] == list(
        range(192, MAX_WIDE_HEAD_DIM + 1, 64))
    assert kernel_family(17, 256) == kernel_family(33, 64) == kernel_family(14, 40) == "general"
    assert kernel_family(25, 160) == kernel_family(1, 1024) == kernel_family(500, 7) == "general"
    assert [d for d in range(1, 1100) if kernel_takes(14, d)] == list(range(1, 1025))
    assert all(kernel_takes(t, 64) for t in (1, 33, 64, 100, 409, 4096))
    assert not kernel_takes(0, 64) and not kernel_takes(3, 1025)


# (B, T, S, heads, D): T of 3, 14 (the UNet's) and 16 (no padding), D of 16
# (a box holds four heads; the last heads' boxes run past C) and 64 (the
# UNet's), S of 5, 24 (the UNet's mid level) and 37, and D = 80 and 128 (two
# boxes); the wide family's D = 256 and 512 (the VAE decoder's one-head
# VideoAttnBlocks), 192 and 320, one head or two.
SHAPES = [(2, 3, 37, 4, 16), (1, 14, 24, 2, 64), (2, 16, 5, 3, 64), (1, 14, 5, 5, 16),
          (1, 3, 24, 1, 64), (1, 16, 37, 2, 16), (1, 14, 5, 2, 80), (1, 4, 6, 2, 128),
          (1, 14, 5, 1, 256), (2, 14, 3, 1, 512), (1, 16, 4, 2, 512), (2, 3, 7, 2, 192),
          (1, 14, 5, 1, 320),
          # Two row tiles: T of 17 (one row past a tile), 25 (SVD-XT's) and 32
          # (no padding), D of 16, 64, 80 and 128, S of 5, 7 and 37.
          (1, 25, 5, 2, 64), (2, 32, 3, 2, 16), (1, 17, 7, 1, 128), (1, 25, 37, 1, 80)]


@pytest.mark.parametrize("b,t,s,heads,d", SHAPES)
def test_k2_model_matches_xla_temporal(b, t, s, heads, d):
    q, k, v = _inputs(b * t, s, heads * d, 11 * t + s)
    scale = d ** -0.5
    xla = jax.jit(partial(_xla_temporal, t=t, heads=heads, scale=scale))
    want = np.asarray(xla(*(jnp.asarray(z.numpy()) for z in (q, k, v))))
    got = k2_model(q, k, v, t, heads, scale, round_p=False)
    assert not torch.isnan(got).any()  # every (frame, position, channel) stored
    assert rel_l2(got.numpy(), want) <= XLA_TOL


def test_k2_model_matches_tpu_kernel_rounding_points():
    """The UNet's T = 14 and D = 64 at a tiny S, bf16 in and out, against the
    Pallas kernel in interpret mode (its default head-pair packing)."""
    _tpu_kernel_case(14, 3)


@pytest.mark.parametrize("t", [25, 32])
def test_k2_tall_model_matches_tpu_kernel_rounding_points(t):
    """Two row tiles (T = 25, SVD-XT's frames, and 32), D = 64 and S = 8 (a
    shape the Pallas kernel's `_supported` takes), against the Pallas
    kernel in interpret mode, with the one-tile bound."""
    _tpu_kernel_case(t, 7 + t)


def _tpu_kernel_case(t, seed):
    b, s, heads, d = 1, 8, 2, 64
    q, k, v = _inputs(b * t, s, heads * d, seed)
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = _pallas_fwd(*(jnp.asarray(z.numpy(), jnp.bfloat16) for z in (q, k, v)),
                           t, heads, scale)
    want = np.asarray(want, np.float32)
    got = _bf16(k2_model(q, k, v, t, heads, scale)).numpy()
    unrounded_p = _bf16(k2_model(q, k, v, t, heads, scale, round_p=False)).numpy()
    assert rel_l2(got, want) <= KERNEL_TOL < 1e-3 < rel_l2(unrounded_p, want)


@pytest.mark.parametrize("d", [256, 512])
def test_k2_wide_model_matches_tpu_kernel_rounding_points(d):
    """The wide family's heads (one head, the VAE decoder's widths) at T =
    14 and a tiny S, bf16 in and out, against the Pallas kernel in
    interpret mode, with the narrow family's bound."""
    b, t, s, heads = 1, 14, 8, 1
    q, k, v = _inputs(b * t, s, heads * d, 5 + d)
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = _pallas_fwd(*(jnp.asarray(z.numpy(), jnp.bfloat16) for z in (q, k, v)),
                           t, heads, scale)
    want = np.asarray(want, np.float32)
    got = _bf16(k2_model(q, k, v, t, heads, scale)).numpy()
    unrounded_p = _bf16(k2_model(q, k, v, t, heads, scale, round_p=False)).numpy()
    assert rel_l2(got, want) <= KERNEL_TOL < 1e-3 < rel_l2(unrounded_p, want)


# The source's schedule, expression by expression (whitespace aside): the
# grid, the per-warp unit order, the ring's first loads, the stage and phase a
# unit is computed from, and the refill one ring behind. The model below runs
# these expressions; a change to any of them in the kernel fails the pin.
SCHEDULE = [
    r"return 233472 / \(smem_bytes<DC, MT>\(\) \+ 1024\);",
    r"return 1024 \+ WARPS \* STAGES \* \(stage_bytes<DC, MT>\(\) \+ "
    r"\(int\)sizeof\(uint64_t\)\);",
    r"return 3 \* DC \* MT \* BOX;",
    r"const long long blocks = \(units \+ WARPS - 1\) / WARPS;",
    r"const long long resident = \(long long\)sms \* blocks_per_sm<DC, MT>\(\);",
    r"<<<\(unsigned\)\(blocks < resident \? blocks : resident\), WARPS \* 32,",
    r"const long long step = \(long long\)gridDim\.x \* WARPS;",
    r"const long long first = \(long long\)blockIdx\.x \* WARPS \+ warp;",
    r"for \(int st = 0; st < STAGES; \+\+st\) if \(first \+ st \* step < units\) "
    r"load\(first \+ st \* step, st\);",
    r"for \(long long u = first; u < units; u \+= step, \+\+i\) \{ const int st = i % STAGES;",
    r"mbar_wait\(&full\[st\], \(i / STAGES\) & 1\);",
    r"if \(lane == 0 && u \+ STAGES \* step < units\) load\(u \+ STAGES \* step, st\);",
]


# The wide family's schedule: the same expressions over WIDE_WARPS and
# WIDE_STAGES.
WIDE_SCHEDULE = [
    r"return 233472 / \(wide_smem_bytes<DC>\(\) \+ 1024\);",
    r"return 1024 \+ WIDE_WARPS \* WIDE_STAGES \* \(stage_bytes<DC>\(\) \+ "
    r"\(int\)sizeof\(uint64_t\)\);",
    r"const long long blocks = \(units \+ WIDE_WARPS - 1\) / WIDE_WARPS;",
    r"const long long resident = \(long long\)sms \* wide_blocks_per_sm<DC>\(\);",
    r"<<<\(unsigned\)\(blocks < resident \? blocks : resident\), WIDE_WARPS \* 32,",
    r"const long long step = \(long long\)gridDim\.x \* WIDE_WARPS;",
    r"const long long first = \(long long\)blockIdx\.x \* WIDE_WARPS \+ warp;",
    r"for \(int st = 0; st < WIDE_STAGES; \+\+st\) if \(first \+ st \* step < units\) "
    r"load\(first \+ st \* step, st\);",
    r"for \(long long u = first; u < units; u \+= step, \+\+i\) \{ "
    r"const int st = i % WIDE_STAGES;",
    r"mbar_wait\(&full\[st\], \(i / WIDE_STAGES\) & 1\);",
    r"if \(lane == 0 && u \+ WIDE_STAGES \* step < units\) "
    r"load\(u \+ WIDE_STAGES \* step, st\);",
]


def blocks_per_sm(d: int, warps: int = WARPS, stages: int = STAGES, mt: int = 1) -> int:
    """`blocks_per_sm` (`wide_blocks_per_sm` with the wide family's warps
    and stages) of the source for units of `mt` row tiles: an SM's 233,472
    bytes of shared memory over a block's rings, barriers and alignment
    slack, plus 1 KB reserved."""
    stage = 3 * -(-d // BOX_CHANNELS) * mt * ROWS * 128
    return 233472 // (1024 + warps * stages * (stage + 8) + 1024)


def test_persistent_schedule_is_the_source_s():
    flat = " ".join(CSRC.read_text().split())
    missing = [e for e in SCHEDULE if not re.search(e, flat)]
    assert not missing


def test_wide_persistent_schedule_is_the_source_s():
    flat = " ".join(CSRC.read_text().split())
    missing = [e for e in WIDE_SCHEDULE if not re.search(e, flat)]
    assert not missing
    # An SM holds two blocks of the wide family at D = 512, five at 192.
    assert [blocks_per_sm(d, WIDE_WARPS, WIDE_STAGES) for d in (192, 256, 512)] == [5, 4, 2]


@pytest.mark.parametrize("units,sms,d", [(960, 132, 64), (15360, 132, 64), (7, 132, 64),
                                         (1000, 3, 128)])
def test_persistent_schedule_loads_and_computes_every_unit_once(units, sms, d):
    """The grid and the per-warp rings as the pinned expressions run them:
    every unit is loaded once into the stage it is computed from, after
    that stage's previous unit was computed, with the phase the wait
    expects, and computed once; no load is left in flight at exit."""
    _schedule_computes_every_unit_once(units, sms, d, WARPS, STAGES)


# Two row tiles: one T = 25 clip with CFG at ds1 (2 x 1536 x 5 units) and at
# ds4 (2 x 96 x 20), D = 128 (one block an SM), and a grid smaller than the
# work.
@pytest.mark.parametrize("units,sms,d", [(15360, 132, 64), (3840, 132, 64), (960, 132, 128),
                                         (1000, 3, 64)])
def test_tall_persistent_schedule_loads_and_computes_every_unit_once(units, sms, d):
    # Eight warps an SM at D <= 64, four at 128: half the one-tile units'.
    assert [blocks_per_sm(e, mt=2) for e in (16, 64, 128)] == [2, 2, 1]
    _schedule_computes_every_unit_once(units, sms, d, WARPS, STAGES, mt=2)


# The VAE decoder's mid block (1536 units at D = 512), its D = 256 level
# (6144), and a grid smaller than the work.
@pytest.mark.parametrize("units,sms,d", [(1536, 132, 512), (6144, 132, 256), (50, 3, 320)])
def test_wide_persistent_schedule_loads_and_computes_every_unit_once(units, sms, d):
    _schedule_computes_every_unit_once(units, sms, d, WIDE_WARPS, WIDE_STAGES)


def _schedule_computes_every_unit_once(units, sms, d, WARPS, STAGES, mt=1):
    blocks = (units + WARPS - 1) // WARPS
    resident = sms * blocks_per_sm(d, WARPS, STAGES, mt)
    step = (blocks if blocks < resident else resident) * WARPS
    computed = []
    for first in range(step):
        ring = [None] * STAGES  # (unit, loads into the stage so far)
        loads = [0] * STAGES
        for st in range(STAGES):
            if first + st * step < units:
                ring[st], loads[st] = first + st * step, 1
        for i, u in enumerate(range(first, units, step)):
            st = i % STAGES
            assert ring[st] == u
            assert (loads[st] - 1) & 1 == (i // STAGES) & 1  # the phase mbar_wait expects
            computed.append(u)
            ring[st] = None
            if u + STAGES * step < units:
                ring[st], loads[st] = u + STAGES * step, loads[st] + 1
        assert all(x is None for x in ring)
    assert sorted(computed) == list(range(units))


# ---- the general family (temporal_attention_general_kernel) ---------------


def general_chunk(dp: int) -> int:
    """`gen_chunk`: O's channels a second pass at padded head size dp."""
    return dp if dp <= 128 else GEN_CHUNK


def k2_general_model(q3, k3, v3, t: int, heads: int, scale: float, round_p: bool = True):
    """fp32 (B*T, S, C) out of fp32 (B*T, S, C) q, k, v, as the general
    family tiles it; the output before its final rounding to bf16: per unit
    (video, position, head; head fastest), D padded with zero channels to
    DP (the next multiple of 16) and T with zero frames to MT strips of 16;
    for each query strip, pass 0 over the key tiles of 16 for the row
    maxima, then per chunk of O's channels (all DP up to 128, else 64 at a
    time) P = exp(s - max) tile by tile, the row sums from the unrounded P
    (tile by tile), P rounded to bf16, O += P V, O / sum; stored at frames
    < T, channels < D of an output that starts as NaN."""
    bt, s, c = q3.shape
    b, d = bt // t, c // heads
    dp, mt = -(-d // 16) * 16, -(-t // ROWS)
    cw = general_chunk(dp)

    def slabs(z):  # (units, 16 MT, DP), units in the kernel's order
        x = z.reshape(b, t, s, heads, d).permute(0, 2, 3, 1, 4).reshape(b * s * heads, t, d)
        return F.pad(x, (0, dp - d, 0, ROWS * mt - t))

    qs, ks, vs = slabs(q3), slabs(k3), slabs(v3)
    out = torch.zeros_like(qs)
    for m in range(mt):
        qm = qs[:, ROWS * m:ROWS * (m + 1)]

        def scores(n):
            sc = (qm @ ks[:, ROWS * n:ROWS * (n + 1)].transpose(1, 2)) * scale
            return sc.masked_fill(torch.arange(ROWS * n, ROWS * (n + 1)) >= t, -math.inf)

        mx = torch.stack([scores(n).amax(-1) for n in range(mt)]).amax(0)[..., None]
        denom = 0.0
        for c0 in range(0, dp, cw):
            acc = 0.0
            for n in range(mt):
                p = torch.exp(scores(n) - mx)
                if c0 == 0:
                    denom = denom + p.sum(-1, keepdim=True)
                acc = acc + (_bf16(p) if round_p else p) @ vs[:, ROWS * n:ROWS * (n + 1),
                                                               c0:c0 + cw]
            out[:, ROWS * m:ROWS * (m + 1), c0:c0 + cw] = acc / denom
    u = torch.arange(b * s * heads)
    h, pos, vid = u % heads, (u // heads) % s, u // (heads * s)
    stored = torch.full((bt * s * c,), math.nan)
    offset = (((vid[:, None, None] * t + torch.arange(t)[None, :, None]) * s
               + pos[:, None, None]) * c + h[:, None, None] * d
              + torch.arange(d)[None, None, :])
    stored[offset.flatten()] = out[:, :t, :d].flatten()
    return stored.reshape(bt, s, c)


# (B, T, S, heads, D): T past 32 (33, 40, 64, 100) at the UNet's D = 64; the
# `num_heads` UNet's D = 40 and 160 (not a multiple of 16; above 128 and not
# a multiple of 64: three chunks of O, the last 32 channels wide); 72, 88,
# 100 (C = 300: no 16-byte copies) and 176; the wide heads past 16 frames
# (256 at T = 17, 512 at T = 25); D = 1000 (16 chunks); T = 1.
GENERAL_SHAPES = [(1, 33, 5, 2, 64), (2, 40, 3, 1, 64), (1, 64, 4, 2, 64), (1, 100, 3, 1, 64),
                  (1, 14, 5, 8, 40), (1, 40, 3, 2, 40), (1, 14, 4, 2, 88), (1, 14, 5, 2, 160),
                  (2, 7, 3, 3, 72), (1, 17, 5, 3, 100), (1, 33, 2, 1, 176), (1, 17, 4, 2, 256),
                  (1, 25, 3, 1, 512), (1, 3, 2, 1, 1000), (2, 1, 5, 2, 40)]


@pytest.mark.parametrize("b,t,s,heads,d", GENERAL_SHAPES)
def test_k2_general_model_matches_xla_temporal(b, t, s, heads, d):
    assert kernel_family(t, d) == "general"
    q, k, v = _inputs(b * t, s, heads * d, 13 * t + d)
    scale = d ** -0.5
    xla = jax.jit(partial(_xla_temporal, t=t, heads=heads, scale=scale))
    want = np.asarray(xla(*(jnp.asarray(z.numpy()) for z in (q, k, v))))
    got = k2_general_model(q, k, v, t, heads, scale, round_p=False)
    assert not torch.isnan(got).any()
    assert rel_l2(got.numpy(), want) <= XLA_TOL


@pytest.mark.parametrize("t", [40, 64])
def test_k2_general_model_matches_tpu_kernel_rounding_points(t):
    """Past 32 frames (T = 40 and 64, D = 64, S = 8: shapes the Pallas
    kernel's `_supported` takes), bf16 in and out, against the Pallas
    kernel in interpret mode, with the narrow family's bound; with P left
    unrounded the model is above 1e-3 from it."""
    b, s, heads, d = 1, 8, 2, 64
    q, k, v = _inputs(b * t, s, heads * d, 3 + t)
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = _pallas_fwd(*(jnp.asarray(z.numpy(), jnp.bfloat16) for z in (q, k, v)),
                           t, heads, scale)
    want = np.asarray(want, np.float32)
    got = _bf16(k2_general_model(q, k, v, t, heads, scale)).numpy()
    unrounded_p = _bf16(k2_general_model(q, k, v, t, heads, scale, round_p=False)).numpy()
    assert rel_l2(got, want) <= KERNEL_TOL < 1e-3 < rel_l2(unrounded_p, want)


# JAX's XLA route on bf16 inputs normalises P in fp32 and casts it to bf16
# before PV; K2 rounds the unnormalised P and divides after PV (the TPU
# kernel's points). Measured 2.91e-3 to 2.94e-3 relative L2 at the two
# shapes below over three seeds each; bound 4e-3.
BF16_XLA_TOL = 4e-3


@pytest.mark.parametrize("b,t,s,heads,d", [(1, 14, 12, 8, 40), (1, 14, 6, 8, 160)])
def test_k2_general_model_against_xla_temporal_in_bf16(b, t, s, heads, d):
    """The `num_heads: 8` UNet's head sizes that JAX's `_supported` refuses
    (D = 40 at ds1's 320 channels, 160 at ds4's 1280), on bf16 inputs,
    against the XLA route JAX takes for them."""
    q, k, v = _inputs(b * t, s, heads * d, 17 + d)
    scale = d ** -0.5
    want = np.asarray(_xla_temporal(*(jnp.asarray(z.numpy(), jnp.bfloat16) for z in (q, k, v)),
                                    t, heads, scale), np.float32)
    got = _bf16(k2_general_model(q, k, v, t, heads, scale)).numpy()
    assert rel_l2(got, want) <= BF16_XLA_TOL


# The general family's schedule, expression by expression: the grid, the
# smem and residency rule, the job order and its decoding, the slots a job
# loads into and reads from, and the two waits.
GENERAL_SCHEDULE = [
    r"return 16 \+ ROWS \* 2 \* \(GEN_STAGES \* \(w \+ 1\) \* \(dp \+ GEN_PAD\) \+ "
    r"\(GEN_STAGES \+ w\) \* \(gen_chunk\(dp\) \+ GEN_PAD\)\);",
    r"return mt > 1 && gen_smem_bytes\(dp, mt < GEN_WARPS \? mt : GEN_WARPS\) > GEN_MAX_SMEM "
    r"\? gen_warps\(mt - 1 < GEN_WARPS \? mt - 1 : GEN_WARPS - 1, dp\) "
    r": \(mt < GEN_WARPS \? mt : GEN_WARPS\);",
    r"return 233472 / \(gen_smem_bytes\(dp, w\) \+ 1024\) < GEN_SM_WARPS / w \? 233472 / "
    r"\(gen_smem_bytes\(dp, w\) \+ 1024\) : GEN_SM_WARPS / w;",
    r"__host__ __device__ constexpr int gen_chunk\(int dp\) \{ return dp <= 128 \? dp : "
    r"GEN_CHUNK; \}",
    r"const int dp = gen_padded\(D\), w = gen_warps\(\(T \+ ROWS - 1\) / ROWS, dp\);",
    r"const long long resident = \(long long\)sms \* gen_blocks_per_sm\(dp, w\);",
    r"<<<\(unsigned\)\(units < resident \? units : resident\), 32 \* w, smem, stream>>>",
    r"const int passes = 1 \+ \(DP \+ CW - 1\) / CW, groups = \(MT \+ W - 1\) / W;",
    r"const long long step = gridDim\.x, first = blockIdx\.x;",
    r"\+\+j\.job; if \(\+\+j\.n < MT\) return; j\.n = 0; if \(\+\+j\.p < passes\) return; "
    r"j\.p = 0; \+\+j\.group; if \(\+\+j\.g < groups\) return; j\.g = 0; j\.u \+= step;",
    r"const int slot = \(int\)\(j\.job % GEN_STAGES\); if \(j\.p == 0 && j\.n == 0\) "
    r"load_rows<VEC>\(qb \+ \(int\)\(j\.group % GEN_STAGES\) \* W \* ROWS \* RQ, RQ, q \+ j\.at, "
    r"fs, ROWS \* W \* j\.g, ROWS \* W, T, 0, DP, D, tid, threads\);",
    r"load_rows<VEC>\(kb \+ slot \* ROWS \* RQ, RQ, k \+ j\.at, fs, ROWS \* j\.n, ROWS, T, 0, "
    r"DP, D, tid, threads\);",
    r"if \(j\.p > 0\) load_rows<VEC>\(vb \+ slot \* ROWS \* RV, RV, v \+ j\.at, fs, ROWS \* j\.n, "
    r"ROWS, T, CW \* \(j\.p - 1\), CW, D, tid, threads\);",
    r"GenJob cur\{first, slab\(first\), 0, 0, 0, 0u, 0u\}, ahead = cur; "
    r"for \(int i = 0; i < GEN_STAGES - 1; \+\+i\) \{ if \(ahead\.u < units\) \{ issue\(ahead\); "
    r"next\(ahead\); \} cp_async_commit\(\); \}",
    r"for \(; cur\.u < units; next\(cur\)\) \{ __syncthreads\(\);.{0,90}"
    r"if \(ahead\.u < units\) \{ issue\(ahead\); next\(ahead\); \} cp_async_commit\(\); "
    r"cp_async_wait<GEN_STAGES - 1>\(\); __syncthreads\(\);",
    r"const int p = cur\.p, n = cur\.n, m = W \* cur\.g \+ warp;.{0,60}if \(m >= MT\) continue;",
    r"const uint32_t qs = qb \+ \(\(int\)\(cur\.group % GEN_STAGES\) \* W \+ warp\) \* ROWS \* RQ, "
    r"ks = kb \+ \(int\)\(cur\.job % GEN_STAGES\) \* ROWS \* RQ, "
    r"vs = vb \+ \(int\)\(cur\.job % GEN_STAGES\) \* ROWS \* RV;",
    r"if \(p == 0\) \{ // the row maxima, over every key tile if \(n == 0\) m0 = m1 = -INFINITY;",
    r"if \(n == 0\) \{ .* if \(p == 1\) l0 = l1 = 0\.0f; \}",
    r"if \(n < MT - 1\) continue;",
]


def general_smem(dp: int, w: int) -> int:
    return 16 + ROWS * 2 * (GEN_STAGES * (w + 1) * (dp + GEN_PAD)
                            + (GEN_STAGES + w) * (general_chunk(dp) + GEN_PAD))


def general_warps(mt: int, dp: int) -> int:
    """`gen_warps`: one warp a query strip, at most GEN_WARPS, as many as
    fit in GEN_MAX_SMEM."""
    w = min(mt, GEN_WARPS)
    while w > 1 and general_smem(dp, w) > GEN_MAX_SMEM:
        w -= 1
    return w


def gen_blocks_per_sm(dp: int, w: int) -> int:
    return min(233472 // (general_smem(dp, w) + 1024), GEN_SM_WARPS // w)


def test_general_schedule_is_the_source_s():
    flat = " ".join(CSRC.read_text().split())
    missing = [e for e in GENERAL_SCHEDULE if not re.search(e, flat)]
    assert not missing
    # Four warps a block from 4 strips (T > 48) up to DP = 512, two at 1024;
    # one warp at T <= 16. Blocks an SM at DP = 64: sixteen of one warp,
    # four of four (16 warps); one of two warps at DP = 1024 (207 KB).
    assert [general_warps(mt, 64) for mt in (1, 2, 3, 4, 7)] == [1, 2, 3, 4, 4]
    assert [general_warps(7, dp) for dp in (160, 512, 1024)] == [4, 4, 2]
    assert [gen_blocks_per_sm(64, w) for w in (1, 4)] == [13, 4]
    assert gen_blocks_per_sm(1024, 2) == 1 and general_smem(1024, 2) <= GEN_MAX_SMEM


@pytest.mark.parametrize("units,sms,t,d", [(15360, 132, 64, 64), (1920, 132, 33, 64),
                                           (500, 3, 100, 40), (7, 132, 17, 160),
                                           (40, 2, 3, 1000), (30, 2, 70, 1024)])
def test_general_schedule_computes_every_strip_and_chunk_once(units, sms, t, d):
    """The pinned job order as the source runs it, block by block: the job
    ahead is loaded into slots that the job computed does not read (its key
    and value slot, and its strip group's query slot if it starts a group),
    each strip's pass 0 sees every key tile before any of its P, and every
    (unit, strip, chunk) is stored once, by the warp of its strip, after
    its last key tile."""
    dp = -(-d // 16) * 16
    cw = general_chunk(dp)
    mt = -(-t // ROWS)
    w = general_warps(mt, dp)
    passes, groups = 1 + -(-dp // cw), -(-mt // w)
    step = min(units, sms * gen_blocks_per_sm(dp, w))
    stored = []

    def nxt(j):  # the source's `next`: (u, g, p, n, job, group)
        u, g, p, n, job, group = j
        job += 1
        n += 1
        if n < mt:
            return (u, g, p, n, job, group)
        n, p = 0, p + 1
        if p < passes:
            return (u, g, p, n, job, group)
        p, group, g = 0, group + 1, g + 1
        if g < groups:
            return (u, g, p, n, job, group)
        return (u + step, 0, p, n, job, group)

    for first in range(step):
        cur = (first, 0, 0, 0, 0, 0)
        ahead = nxt(cur)  # GEN_STAGES - 1 = 1 job issued before the loop
        assert GEN_STAGES == 2
        maxed = set()
        while cur[0] < units:
            if ahead[0] < units:  # issued into slots the current job does not read
                assert ahead[4] % GEN_STAGES != cur[4] % GEN_STAGES
                if ahead[2:4] == (0, 0):
                    assert ahead[5] % GEN_STAGES != cur[5] % GEN_STAGES
                ahead = nxt(ahead)
            u, g, p, n = cur[:4]
            for warp in range(w):
                m = w * g + warp
                if m >= mt:
                    continue
                if p == 0:
                    maxed.add((u, m, n))
                    continue
                assert all((u, m, i) in maxed for i in range(mt))
                if n == mt - 1:
                    stored.append((u, m, p - 1))
            cur = nxt(cur)
    assert sorted(stored) == [(u, m, c) for u in range(units) for m in range(mt)
                              for c in range(-(-dp // cw))]

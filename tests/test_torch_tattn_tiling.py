"""K2 (csrc/temporal_attention.cu) on the CPU: a torch model of its tiling
held against the JAX package's Pallas kernel (`_kernel` through
`_pallas_fwd`, in interpret mode) and against its XLA formulation
(`_xla_temporal`), its persistent schedule pinned to the source and
checked, and its tile constants pinned to the source.

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
    MAX_HEAD_DIM,
    MAX_WIDE_FRAMES,
    MAX_WIDE_HEAD_DIM,
    kernel_head_dim,
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
    <= 16 in one."""
    src = CSRC.read_text()
    assert ROWS == MAX_WIDE_FRAMES == 16 and MAX_ROW_TILES * ROWS == MAX_FRAMES == 32
    assert re.search(r"const uint32_t box\[4\] = \{64, 1, \(uint32_t\)\(MT \* ROWS\), 1\};",
                     src)
    assert re.search(r"return T <= ROWS \? launch<KC, 1>\(.*\)\s*: launch<KC, 2>\(", src)
    assert re.search(r"T > MAX_ROW_TILES \* ROWS", src)
    assert re.search(r"switch \(D % 16 \? 0 : D / 16\)", src)
    assert re.search(r"if \(D > 128\) \{\s*if \(T > ROWS\) return \(int\)cudaErrorInvalidValue;"
                     r"\s*switch \(D % 64 \? 0 : D / 64\)", src)
    assert [d for d in range(1, 1100) if kernel_head_dim(d)] == (
        list(range(16, MAX_HEAD_DIM + 1, 16)) + list(range(192, MAX_WIDE_HEAD_DIM + 1, 64)))
    assert MAX_WIDE_HEAD_DIM == 512
    assert [t for t in range(40) if kernel_takes(t, 96)] == list(range(1, 33))
    assert [t for t in range(40) if kernel_takes(t, 256)] == list(range(1, 17))
    assert not kernel_takes(25, 40) and not kernel_takes(33, 64)


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

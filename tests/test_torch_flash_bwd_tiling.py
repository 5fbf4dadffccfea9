"""K6 (csrc/flash_attention_bwd.cu) on the CPU: a torch model of its tiling
held against the JAX package's Pallas backward (`_flash_bwd_rows` in
interpret mode), and its tile constant pinned to the source.

The model computes as the two kernels do, in fp32:
  - rows, pass 1: 64-key tiles in order; per query row the running max of
    the raw scores (log2 domain), the rescaled sum of exp2 and delta's
    numerator sum exp2(s' - max) dP; lse = max + log2(sum), delta =
    numerator / sum; padded query rows get (lse = +inf, delta = 0);
  - rows, pass 2: the key tiles again, P = exp2(s scale log2(e) - lse),
    dS = bf16(P (dP - delta) scale), dQ += dS K;
  - dkdv: 64-query tiles in order, P^T from S^T = K Q^T and the rows'
    (lse, delta), dV += bf16(P^T) dO + bf16(P^T - bf16(P^T)) dO (P's hi and
    lo halves), dK += bf16(dS^T) Q.
Both sides take the same bf16 inputs (JAX in bf16, the model in fp32
holding bf16 values), so dS is rounded at the same points; the outputs are
the fp32 sums before their last rounding. The fp32 P differs in its last
bits (exp2 against exp, another order of sums), so the few dS values within
that of a bf16 rounding boundary round the other way, each moving dQ and dK
by 2^-8 of one term: 4e-8 to 1.2e-4 relative L2 over several seeds at
these sizes, bounded by 5e-4 (chip_smoke.py holds the kernel to 1e-2 on the
card). dV has no dS in it: 2.5e-6 (P's hi + lo carries 16 of its bits),
bounded by 1e-5.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gcd_tpu.ops.flash_attention import _flash_bwd_rows
from gcd_tpu_torch.ops.flash_attention import BWD_TILE
from tests.torch_port_helpers import rel_l2
from tests.torch_threads import one_torch_thread  # noqa: F401

CSRC = (Path(__file__).resolve().parent.parent / "gcd_tpu_torch" / "csrc"
        / "flash_attention_bwd.cu")
TOL = 5e-4


def _bf16(z: torch.Tensor) -> torch.Tensor:
    return z.to(torch.bfloat16).float()


def k6_model(q, k, v, do, scale: float, split_p: bool = True):
    """(dq, dk, dv), fp32 (BH, S, D), of fp32 (BH, S, D) inputs, in K6's
    tile order; with split_p False, dV takes bf16(P^T) alone."""
    t = BWD_TILE
    bh, s, d = q.shape
    n = -(-s // t)
    sp = n * t
    qp, kp, vp, dop = (F.pad(z, (0, 0, 0, sp - s)) for z in (q, k, v, do))
    c = scale * math.log2(math.e)
    valid = torch.arange(sp) < s

    # Rows pass 1: online statistics over the key tiles.
    m = torch.full((bh, sp), -math.inf)
    l = torch.zeros(bh, sp)
    a = torch.zeros(bh, sp)
    for j in range(n):
        cols = slice(j * t, (j + 1) * t)
        sc = qp @ kp[:, cols].transpose(1, 2)
        dp = dop @ vp[:, cols].transpose(1, 2)
        sc = torch.where(valid[cols], sc, -math.inf)
        new = torch.maximum(m, sc.amax(-1) * c)
        r = torch.exp2(m - new)
        e = torch.exp2(sc * c - new[..., None])
        l = l * r + e.sum(-1)
        a = a * r + (e * dp).sum(-1)
        m = new
    lse = torch.where(valid, m + torch.log2(l), math.inf)
    delta = torch.where(valid, a / l, 0.0)

    # Rows pass 2: dQ += dS K over the key tiles.
    dq = torch.zeros(bh, sp, d)
    for j in range(n):
        cols = slice(j * t, (j + 1) * t)
        sc = qp @ kp[:, cols].transpose(1, 2)
        dp = dop @ vp[:, cols].transpose(1, 2)
        p = torch.where(valid[cols], torch.exp2(sc * c - lse[..., None]), 0.0)
        dq = dq + _bf16(p * (dp - delta[..., None]) * scale) @ kp[:, cols]

    # dkdv: dV and dK over the query tiles.
    dk = torch.zeros(bh, sp, d)
    dv = torch.zeros(bh, sp, d)
    for j in range(n):
        rows = slice(j * t, (j + 1) * t)
        st = kp @ qp[:, rows].transpose(1, 2)
        dpt = vp @ dop[:, rows].transpose(1, 2)
        pt = torch.exp2(st * c - lse[:, None, rows])
        hi = _bf16(pt)
        dv = dv + hi @ dop[:, rows]
        if split_p:
            dv = dv + _bf16(pt - hi) @ dop[:, rows]
        dk = dk + _bf16(pt * (dpt - delta[:, None, rows]) * scale) @ qp[:, rows]
    return dq[:, :s], dk[:, :s], dv[:, :s]


def _inputs(bh, s, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(bh, s, d)).astype(np.float32)).to(
        torch.bfloat16) for _ in range(4)]


def _jax(ins, scale):
    out = _flash_bwd_rows(*(jnp.asarray(z.float().numpy(), jnp.bfloat16) for z in ins),
                          scale, interpret=True)
    return [np.asarray(o, np.float32) for o in out]


def test_tile_matches_the_kernel():
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", CSRC.read_text()))
    assert int(consts["TR"]) == BWD_TILE == 64


# The UNet's mid (S = 24, shorter than one tile) and ds4 (S = 96) levels, and
# an S that is not a multiple of the tile (two tiles, the second ragged).
@pytest.mark.parametrize("bh,s,d", [(3, 24, 64), (2, 96, 64), (2, 100, 64)])
def test_k6_model_matches_tpu_backward_kernel(bh, s, d):
    ins = _inputs(bh, s, d, s)
    scale = d ** -0.5
    got = k6_model(*(z.float() for z in ins), scale)
    for name, g, want in zip(("dq", "dk", "dv"), got, _jax(ins, scale)):
        assert g.shape == want.shape == (bh, s, d)
        assert rel_l2(g.numpy(), want) <= TOL, name


def test_p_split_carries_dv_beyond_bf16():
    """dV from P's hi and lo halves agrees with the TPU kernel's fp32 P to
    fp32 order; from bf16(P) alone it is off by bf16's rounding of P."""
    ins = _inputs(2, 100, 64, 7)
    scale = 64 ** -0.5
    want = _jax(ins, scale)[2]
    split = rel_l2(k6_model(*(z.float() for z in ins), scale)[2].numpy(), want)
    hi_only = rel_l2(k6_model(*(z.float() for z in ins), scale, split_p=False)[2].numpy(),
                     want)
    assert split <= 1e-5 < 1e-3 <= hi_only

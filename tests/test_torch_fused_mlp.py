"""K3 (ops/fused_mlp.py, csrc/fused_mlp.cu) on the CPU.

`geglu_mlp_plain` and a model of the CUDA kernels' arithmetic are held
against the TPU kernel's own body: `_fused_forward` run under
`pltpu.force_tpu_interpret_mode()` with exact GELU (GCD_EXACT_GELU=1), as
tests/test_fused_mlp.py runs it. The wrapper's copies of the kernels' tiling
constants are pinned to csrc/fused_mlp.cu, and the shape rule by which the
wrapper picks the down kernel's tile is checked at the UNet's shapes.

Tolerances: in fp32 the plain version and the TPU kernel compute the same
sums in another order (and the TPU kernel's erf is the Abramowitz & Stegun
form, |error| <= 1.5e-7), ~2e-7 relative L2 measured: bound 2e-5, as
tests/test_fused_mlp.py. In bf16 the model rounds where the TPU kernel's
code rounds (it equals that arithmetic written out in JAX outside the
kernel), yet the interpreted kernel reads 3.4e-3 relative L2 from both
(measured, three seeds): bound 1e-2, the chip gate for the CUDA kernels.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcd_tpu.ops.fused_mlp import _fused_forward
from gcd_tpu_torch.ops.fused_mlp import (
    DOWN_ROWS,
    DOWN_TILES,
    INNER_TILE,
    check_shape,
    down_tile,
    geglu_mlp_plain,
)
from tests.torch_port_helpers import rel_l2
from tests.torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(__file__).resolve().parent.parent / "gcd_tpu_torch" / "csrc" / "fused_mlp.cu"
FP32_TOL = 2e-5
BF16_TOL = 1e-2


def _inputs(m, c, inner, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, c)).astype(np.float32)
    w1 = (0.05 * rng.normal(size=(2 * inner, c))).astype(np.float32)  # torch layout
    b1 = (0.05 * rng.normal(size=2 * inner)).astype(np.float32)
    w2 = (0.05 * rng.normal(size=(c, inner))).astype(np.float32)
    b2 = (0.05 * rng.normal(size=c)).astype(np.float32)
    return x, w1, b1, w2, b2


def _tpu_kernel(x, w1, b1, w2, b2, dtype, monkeypatch):
    """The TPU kernel's body in interpret mode, exact GELU; numpy in, fp32 out."""
    monkeypatch.setenv("GCD_EXACT_GELU", "1")
    inner = w2.shape[1]
    xj = jnp.asarray(x).astype(dtype)
    w1j = jnp.asarray(w1.T).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        out = _fused_forward(xj, w1j[:, :inner], w1j[:, inner:],
                             jnp.asarray(b1[:inner]).reshape(1, -1),
                             jnp.asarray(b1[inner:]).reshape(1, -1),
                             jnp.asarray(w2.T).astype(dtype), jnp.asarray(b2).reshape(1, -1),
                             tt=128, it=64)
    return np.asarray(out.astype(jnp.float32))


def _erf_as(z: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz & Stegun 7.1.26, as csrc/fused_mlp.cu's gelu_erf."""
    az = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * az)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (
        -1.453152027 + t * 1.061405429))))
    return torch.sign(z) * (1.0 - poly * torch.exp(-az * az))


def _kernel_model(x, w1, b1, w2, b2):
    """The CUDA kernels' arithmetic on bf16 tensors: fp32 products; a and g
    rounded to bf16, the bf16 bias added with one rounding; h = bf16(a *
    0.5 g (1 + erf(g / sqrt 2))) in fp32; out = bf16(h . W2^T + b2), b2 added
    in fp32."""
    inner = w2.shape[1]
    up = (x.float() @ w1.float().T).to(torch.bfloat16).float() + b1.float()
    up = up.to(torch.bfloat16).float()
    a, g = up[:, :inner], up[:, inner:]
    h = (a * (0.5 * g * (1.0 + _erf_as(g * 0.7071067811865476)))).to(torch.bfloat16)
    return (h.float() @ w2.float().T + b2.float()).to(torch.bfloat16)


@pytest.mark.parametrize("m,c,inner", [(256, 64, 128), (384, 128, 192)])
def test_plain_matches_tpu_kernel_exact_gelu(m, c, inner, monkeypatch):
    x, w1, b1, w2, b2 = _inputs(m, c, inner, seed=m)
    ref = _tpu_kernel(x, w1, b1, w2, b2, jnp.float32, monkeypatch)
    out = geglu_mlp_plain(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)))
    assert out.shape == (m, c)
    assert rel_l2(out.numpy(), ref) <= FP32_TOL


def test_kernel_model_matches_tpu_kernel_in_bf16(monkeypatch):
    # Every input a bf16 value, so both sides start from the same numbers.
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(256, 64, 128, seed=3)]
    ref = _tpu_kernel(*(t.float().numpy() for t in bf), jnp.bfloat16, monkeypatch)
    assert rel_l2(_kernel_model(*bf).float().numpy(), ref) <= BF16_TOL
    assert rel_l2(geglu_mlp_plain(*bf).float().numpy(), ref) <= BF16_TOL


def _constants():
    src = CSRC.read_text()
    consts = {m[0]: m[1] for m in re.findall(r"constexpr int (\w+) = ([^;{]+);", src)}
    ints = {}
    for name, expr in consts.items():  # in source order: each refers to earlier ones
        try:
            ints[name] = int(eval(expr, {}, dict(ints)))
        except (NameError, SyntaxError, TypeError):
            pass
    tiles = re.search(r"constexpr int DOWN_TILES\[\d+\] = \{([^}]*)\};", src).group(1)
    return ints, tuple(int(v) for v in tiles.split(","))


def test_tiling_constants_match_the_kernel():
    ints, tiles = _constants()
    assert {k: ints[k] for k in ("BN_UP", "BM_DOWN")} == {
        "BN_UP": INNER_TILE, "BM_DOWN": DOWN_ROWS}
    assert tiles == DOWN_TILES


# (M, C_out) of the UNet's four levels at one clip (B*T = 28) and at a served
# batch of two clips, and the down tile the rule gives on a 132-SM H100.
DOWN_PICKS = [((43008, 320), 160), ((10752, 640), 160), ((2688, 1280), 256),
              ((672, 1280), 128), ((86016, 320), 160), ((21504, 640), 128),
              ((5376, 1280), 160), ((1344, 1280), 128)]


@pytest.mark.parametrize("shape,tile", DOWN_PICKS)
def test_down_tile_rule(shape, tile):
    """The widest tile that leaves the busiest SM the fewest columns."""
    m, c_out = shape
    assert down_tile(m, c_out, 132) == tile
    rows = -(-m // DOWN_ROWS)
    cost = {bn: -(-rows * -(-c_out // bn) // 132) * bn for bn in DOWN_TILES}
    assert cost[tile] == min(cost.values())
    assert all(bn <= tile for bn in DOWN_TILES if cost[bn] == cost[tile])


def test_shape_requirements():
    check_shape(672, 1280, 5120, 1280)
    for bad in [(64, 12, 128, 64), (64, 64, 96, 64), (64, 64, 128, 12), (0, 64, 128, 64)]:
        with pytest.raises(ValueError):
            check_shape(*bad)

"""The port's exported sampler (gcd_tpu_torch/engine/export.py) and the
K1-K7 custom ops (gcd_tpu_torch/ops/library.py) on the CPU; the export entry
and the comparison with JAX's artifact are in test_torch_export_entry.py.

The ops: each `gcd::` op equals its plain version on the CPU, and
torch.library.opcheck holds each fake implementation (shapes, dtypes and
strides) against the CPU implementation, K4 and K7 on channels-last input.

The artifact: JAX's tiny engine (tests/helpers.py tiny_engine_config, B = 1,
T = 3, 32x48, 3 steps, a 3-frame decode) with seeded weights and a
guidance_interval, carried into the port's engine with io/convert.py, fp32.
The port's artifact reproduces the port's direct `sample_video` with the
same noise within 1e-5 (tests/test_export.py's bound for JAX; measured 0
here: the same ops on the same inputs; the engine's parameters are frozen,
since on the CPU a convolution's algorithm depends on whether its weight
requires grad, and the artifact's weights are the state dict's detached
tensors). The engine and its export are built once.
"""

import copy
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gcd_tpu.utils.config import instantiate_from_config as j_instantiate
from gcd_tpu_torch.engine.build import engine_from_config
from gcd_tpu_torch.engine.export import export_sampler, load_sampler
from gcd_tpu_torch.ops import (
    flash_attention_bwd_plain,
    flash_attention_plain,
    geglu_mlp_plain,
    gn_silu_conv3x3_plain,
    group_norm_plain,
    group_stats_plain,
    temporal_attention_plain,
)
from gcd_tpu_torch.ops.fused_norm import group_norm_from_sums_plain
from tests.helpers import tiny_engine_config
from tests.torch_port_helpers import engine_params, engine_state_dict, tiny_batch
from tests.torch_threads import one_torch_thread  # noqa: F401

B, T, H, W = 1, 3, 32, 48
STEPS = 3
INTERVAL = (1.0, 100.0)
# opcheck's schema, autograd-registration and fake-tensor tests; its
# aot_dispatch_dynamic test (symbolic shapes through AOTAutograd) takes ten
# times as long and covers nothing the static-shape export uses.
OPCHECKS = ("test_schema", "test_autograd_registration", "test_faketensor")


def _op_cases():
    """(op name, arguments, the plain version's result) at small shapes."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    cl = torch.channels_last
    x4 = r(2, 64, 4, 6).contiguous(memory_format=cl)
    q, k, v, do = (r(2, 16, 64) for _ in range(4))
    tq, tk, tv = (r(6, 8, 32) for _ in range(3))
    mlp = (r(2, 5, 16), r(128, 16), r(128), r(16, 64), r(16))
    gw, gb = 1.0 + 0.1 * r(64), 0.1 * r(64)
    conv = (r(64, 64, 3, 3).contiguous(memory_format=cl), r(64))
    s1, s2 = group_stats_plain(x4, 32)
    video = r(1, 3, 64, 4, 6).transpose(1, 2)  # the time_stack view of a (B, T, C, H, W) video
    return [
        ("flash_attention", (q, k, v, 2, None), flash_attention_plain(q, k, v, 2)),
        ("flash_attention_bwd", (q, k, v, do, 2, 0.3),
         flash_attention_bwd_plain(q, k, v, do, 2, 0.3)),
        ("temporal_attention", (tq, tk, tv, 3, 2, None), temporal_attention_plain(tq, tk, tv, 3, 2)),
        ("geglu_mlp", mlp, geglu_mlp_plain(*mlp)),
        ("group_norm", (x4, gw, gb, 32, 1e-5, True, True),
         group_norm_plain(x4, gw, gb, 32, 1e-5, True)),
        ("group_norm", (video, gw, gb, 32, 1e-6, False, True),
         group_norm_plain(video, gw, gb, 32, 1e-6, False)),
        ("group_stats", (x4, 32), torch.stack(group_stats_plain(x4, 32))),
        ("group_norm_from_sums", (x4, gw, gb, 32, 1e-5, True, s1, s2, 48),
         group_norm_from_sums_plain(x4, gw, gb, 32, 1e-5, True, s1, s2, 48)),
        ("gn_silu_conv3x3", (x4, gw, gb, *conv, 32, 1e-5, True, True),
         gn_silu_conv3x3_plain(x4, gw, gb, *conv, 32, 1e-5, True)),
    ]


@pytest.mark.parametrize("case", range(len(_op_cases())))
def test_op_matches_plain_and_fake(case):
    """The op's CPU implementation is the plain version, bit for bit and in
    the same layout; its fake implementation gives the CPU output's shape,
    dtype and strides (torch.library.opcheck), K4 and K7 on channels-last
    input and K4 on the time_stack view too."""
    name, args, plain = _op_cases()[case]
    op = getattr(torch.ops.gcd, name).default
    out = op(*args)
    outs, plains = (out, plain) if isinstance(out, tuple) else ((out,), (plain,))
    for o, p in zip(outs, plains):
        assert torch.equal(o, p) and o.stride() == p.stride()
    torch.library.opcheck(op, args, test_utils=OPCHECKS)


class _OpCalls(TorchDispatchMode):
    """Counts the gcd:: ops called under it."""

    def __init__(self):
        super().__init__()
        self.calls = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "gcd":
            self.calls[func.__name__.split(".")[0]] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny engine with seeded weights and guidance_interval (1, 100),
    which guides only the middle step of the 3-step ladder (700, 15.6,
    0.002); the port's engine on the same weights and interval, the batch,
    and the port's artifact of it (the step and the plain step)."""
    cfg = tiny_engine_config()
    batch = tiny_batch(T, H, W, 8)
    jeng = j_instantiate(copy.deepcopy(cfg))
    jeng.sampler.guidance_interval = INTERVAL
    params = engine_params(jeng, batch, 20)
    emb_models = cfg["params"]["conditioner_config"]["params"]["emb_models"]
    engine = engine_from_config(copy.deepcopy(cfg), "cpu", torch.float32,
                                engine_state_dict(params, emb_models, 30))
    engine.sampler.guidance_interval = INTERVAL
    engine.requires_grad_(False)  # the artifact's weights are the state dict's detached tensors
    assert engine.sampler.guided_steps(STEPS) == [False, True, False]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    blob = export_sampler(engine, engine.state_dict(), tbatch, num_steps=STEPS, decoding_t=T)
    return {"jeng": jeng, "params": params, "batch": batch, "engine": engine,
            "tbatch": tbatch, "blob": blob, "sample": load_sampler(blob)}


def _noise(seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B * T, H // 8, W // 8, 4)).astype(np.float32))


def test_artifact_matches_direct_call(tiny):
    """The artifact (with its plain step) against engine.sample_video with
    the same noise: the same keys and shapes, within 1e-5 (measured 0)."""
    engine, noise = tiny["engine"], _noise(1)
    out = tiny["sample"](engine.state_dict(), tiny["tbatch"], noise=noise)
    direct = engine.sample_video(tiny["tbatch"], noise=noise, num_steps=STEPS, decoding_t=T)
    assert sorted(tiny["sample"].header["programs"]) == ["cond", "decode", "plain", "step"]
    assert sorted(out) == sorted(direct) == ["cond_video", "sampled_video"]
    assert out["sampled_video"].shape == (B * T, H, W, 3)
    assert float(direct["sampled_video"].std()) > 1e-2
    for key in out:
        np.testing.assert_allclose(out[key].numpy(), direct[key].numpy(), rtol=1e-5, atol=1e-5)


def test_artifact_calls_the_ops_as_the_direct_call(tiny):
    """The exported programs hold gcd:: nodes, and a sample calls each op
    as often as the direct sample_video does (the tiny UNet's 16-wide heads
    take the plain attention, not K1); a generator draws the noise as
    engine.latent_noise does."""
    programs = tiny["sample"].programs
    assert sorted(programs) == ["cond", "decode", "plain", "step"]
    nodes = {n: Counter(str(node.target).split(".")[1] for node in p.gm.graph.nodes
                        if node.op == "call_function" and str(node.target).startswith("gcd."))
             for n, p in programs.items()}
    assert nodes["step"] == nodes["plain"]
    assert {"temporal_attention", "geglu_mlp", "group_norm", "gn_silu_conv3x3"} <= set(
        nodes["step"])
    assert nodes["decode"]["group_norm"] > 0 and nodes["cond"]["group_norm"] > 0
    engine = tiny["engine"]
    with _OpCalls() as art:
        out = tiny["sample"](engine.state_dict(), tiny["tbatch"],
                             generator=torch.Generator().manual_seed(5))
    with _OpCalls() as direct:
        ref = engine.sample_video(tiny["tbatch"], generator=torch.Generator().manual_seed(5),
                                  num_steps=STEPS, decoding_t=T)
    assert art.calls == direct.calls
    assert art.calls["geglu_mlp"] == STEPS * nodes["step"]["geglu_mlp"]
    assert torch.equal(out["sampled_video"], ref["sampled_video"])


def test_artifact_rejects_wrong_shape_and_holds_no_weights(tiny):
    """A cond_frames of half the height raises, so do missing arrays; the
    blob is smaller than the weights, which it does not hold."""
    arrays = dict(tiny["tbatch"])
    arrays["cond_frames"] = arrays["cond_frames"][:, : H // 2]
    with pytest.raises(ValueError, match="cond_frames"):
        tiny["sample"](tiny["engine"].state_dict(), arrays, noise=_noise(2))
    arrays = {k: v for k, v in tiny["tbatch"].items() if k != "fps_id"}
    with pytest.raises(KeyError, match="fps_id"):
        tiny["sample"](tiny["engine"].state_dict(), arrays, noise=_noise(2))
    weights = sum(p.numel() * p.element_size() for p in tiny["engine"].parameters())
    assert len(tiny["blob"]) < weights

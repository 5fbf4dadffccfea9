"""The tensor-parallel modules (gcd_tpu_torch/parallel/tensor.py cut_unet,
models/attention.py, models/layers.py) in two gloo processes at tensor 2,
against the JAX package's modules on the same converted weights.

At the tiny engine's width (32 channels, 2 heads of 16, a GEGLU of 128
inner columns, 24-wide context): CrossAttention as self-attention, over a
5-token context and over one token (the shortcut), TemporalSelfAttention
over 3 frames, FeedForward, and a time_stack VideoTransformerBlock with
ff_in and a one-token per-video context. Each rank holds one head and 64
inner columns ([value_r | gate_r] of net.0.proj); its output, the input
gradients (summed over the group by copy_to_tensor_group) and the weight
gradients gathered whole equal JAX's forward and `jax.grad` of
sum(out * cotangent) to 1e-4 relative L2 (fp32: the same sums in another
order, as tests/test_torch_modules.py holds the uncut modules), and the two
ranks agree bit for bit. The JAX side runs in this process; the weights,
inputs and JAX's results go to the processes through a file.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
B, T, S, C, HEADS, D, CTX = 2, 3, 10, 32, 2, 16, 24
CASES = ("self", "cross", "one_token", "temporal", "ff", "time_block")


def _port_module(case: str) -> torch.nn.Module:
    from gcd_tpu_torch.models.attention import CrossAttention, TemporalSelfAttention
    from gcd_tpu_torch.models.layers import FeedForward
    from gcd_tpu_torch.models.video_attention import VideoTransformerBlock

    return {"self": lambda: CrossAttention(C, HEADS, D),
            "cross": lambda: CrossAttention(C, HEADS, D, CTX),
            "one_token": lambda: CrossAttention(C, HEADS, D, CTX),
            "temporal": lambda: TemporalSelfAttention(C, HEADS, D),
            "ff": lambda: FeedForward(C),
            "time_block": lambda: VideoTransformerBlock(C, HEADS, D, CTX, ff_in=True)}[case]()


def _reference(case: str, seed: int):
    """JAX's module on seeded weights and inputs: (torch state dict, inputs,
    cotangent, output, input gradients, weight gradients by torch key)."""
    import jax
    import jax.numpy as jnp
    from gcd_tpu.models.attention import CrossAttention as JCross
    from gcd_tpu.models.attention import TemporalSelfAttention as JTemporal
    from gcd_tpu.models.layers import FeedForward as JFeedForward
    from gcd_tpu.models.video_attention import VideoTransformerBlock as JBlock
    from gcd_tpu_torch.io.convert import state_dict_from_flax
    from tests.torch_port_helpers import flax_params

    rng = np.random.default_rng(seed)
    tokens = (B * T, S, C) if case in ("temporal", "time_block") else (B, S, C)
    inputs = [rng.normal(size=tokens).astype(np.float32)]
    kwargs = {}
    if case in ("cross", "one_token", "time_block"):
        inputs.append(rng.normal(size=(B, 5 if case == "cross" else 1, CTX)).astype(np.float32))
    jmod = {"self": lambda: JCross(heads=HEADS, dim_head=D),
            "cross": lambda: JCross(heads=HEADS, dim_head=D, context_dim=CTX),
            "one_token": lambda: JCross(heads=HEADS, dim_head=D, context_dim=CTX),
            "temporal": lambda: JTemporal(heads=HEADS, dim_head=D),
            "ff": lambda: JFeedForward(glu=True),
            "time_block": lambda: JBlock(n_heads=HEADS, d_head=D, context_dim=CTX,
                                         ff_in=True)}[case]()
    if case in ("temporal", "time_block"):
        kwargs["timesteps"] = T
    params = flax_params(jmod, seed + 1, *map(jnp.asarray, inputs), **kwargs)

    def apply(p, *xs):
        return jmod.apply({"params": p}, *xs, **kwargs)

    out = np.asarray(jax.jit(apply)(params, *inputs))
    cot = rng.normal(size=out.shape).astype(np.float32)
    grads = jax.jit(jax.grad(lambda p, *xs: jnp.sum(apply(p, *xs) * cot),
                             argnums=tuple(range(len(inputs) + 1))))(params, *inputs)
    return (state_dict_from_flax(params), inputs, cot, out,
            [np.asarray(g) for g in grads[1:]],
            {k: v.numpy() for k, v in state_dict_from_flax(
                jax.tree_util.tree_map(np.asarray, grads[0])).items()})


def _child(path: str, rank: int, port: int) -> None:
    """One rank of the group: each case's module cut at tensor 2, forward
    and backward; rank 0 writes what it gathered."""
    import torch.distributed as dist

    from gcd_tpu_torch.parallel.mesh import create_mesh, unet_placements
    from gcd_tpu_torch.parallel.tensor import cut_unet

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    mesh = create_mesh(1, 1, 2, "cpu")
    cases = torch.load(path, weights_only=False)
    results = {}
    for case, (sd, inputs, cot) in cases.items():
        holder = torch.nn.ModuleDict({"m": _port_module(case)})
        holder["m"].load_state_dict(sd, strict=True)
        placements = unet_placements(holder, 1, 2, min_weight_size=1)
        cut = cut_unet(holder, placements, mesh.coords["tensor"], 2, mesh.tensor_group)
        xs = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
        extra = (T,) if case in ("temporal", "time_block") else ()
        out = holder["m"](*xs, *extra)
        (out * torch.from_numpy(cot)).sum().backward()
        grads = {k: mesh.gather(torch.zeros_like(p) if p.grad is None else p.grad,
                                placements[f"m.{k}"])
                 for k, p in holder["m"].named_parameters()}
        input_grads = [torch.zeros_like(x) if x.grad is None else x.grad for x in xs]
        results[case] = {"out": out.detach(), "input_grads": input_grads,
                         "grads": grads, "cut": cut,
                         "cut_params": sorted(k for k, p in placements.items()
                                              if p.tensor_dim is not None)}
    peer = [None, None]
    dist.all_gather_object(peer, results)
    if rank == 0:
        torch.save(peer, path + ".out")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp") / "cases.pt")
    refs = {case: _reference(case, 10 * i) for i, case in enumerate(CASES)}
    torch.save({case: r[:3] for case, r in refs.items()}, path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONSTARTUP", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; from tests.test_torch_tensor_parallel import "
         f"_child; _child({path!r}, {rank}, {port})"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return refs, torch.load(path + ".out", weights_only=False)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("case", CASES)
def test_cut_module_matches_jax(ranks, case):
    refs, got = ranks
    _, _, _, out, input_grads, weight_grads = refs[case]
    r0, r1 = got[0][case], got[1][case]
    assert r0["cut"] and r0["cut_params"]  # heads / inner columns were split
    if case == "ff":
        assert r0["cut"] == {"m": 4 * C} and "m.net.0.proj.weight" in r0["cut_params"]
    elif case != "time_block":
        assert r0["cut"] == {"m": HEADS}
    assert _rel(r0["out"], out) <= TOL
    for g, want in zip(r0["input_grads"], input_grads):
        if np.abs(want).max() == 0:  # x under the one-token shortcut: unused
            assert float(g.abs().max()) == 0
            continue
        assert _rel(g, want) <= TOL
    assert sorted(r0["grads"]) == sorted(weight_grads)
    for k, want in weight_grads.items():
        if np.abs(want).max() == 0:  # to_q / to_k under the one-token shortcut
            assert float(r0["grads"][k].abs().max()) == 0, k
            continue
        assert _rel(r0["grads"][k], want) <= TOL, k
    assert torch.equal(r0["out"], r1["out"])
    assert all(torch.equal(a, b) for a, b in zip(r0["input_grads"], r1["input_grads"]))

"""One whole tiny training step of the port against the JAX package's
`train_step`, and the trainable sets of the three ft_strategies.

configs/smoke_kubric_tiny.yaml (the tiny UNet, VAE and conditioner) with
ucg_rate 0: flax's make_rng draws cannot be handed across, and the dropout
has its own test (tests/test_torch_train.py). The port's UNet is
rematerialised (use_checkpoint on). Two videos of two 32x48 frames, the
same weights on both sides, and the port gets JAX's draws rebuilt from the
step's key: the posterior noise from fold_in(k_enc, 0) for the one chunk of
four frames (engine.py:305-311; tests/test_torch_train.py holds the
chunking), the sigma and noise draws from k_loss
(loss.py:118-131). JAX's `train_step` runs whole, once, with its masked
AdamW wrapped so that the optimizer state also keeps the gradients it was
handed. fp32, JAX at highest matmul precision.

Bounds: the loss 1e-5 (the same fp32 sums in another order); the UNet's
gradient 1e-4 (a backward through a dozen layers, summed in another
order). The step's change to the parameters is held to 1e-2 relative L2:
AdamW's first update is lr * (g / (|g| + eps) + decay * p), about lr = 1e-4
per element, and the fp32 parameters (magnitude ~1) round it to their ulp,
~1e-7, in a different order of operations on each side, so each element's
change carries ~1e-3 of rounding.
"""

import copy
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gcd_tpu.engine.trainer import TrainState, make_optimizer, train_step
from gcd_tpu.utils.config import instantiate_from_config as j_instantiate
from gcd_tpu_torch.engine.trainer import Trainer
from gcd_tpu_torch.io.convert import (
    _iter_tree_paths,
    flax_path_to_torch_key,
    gcd_clip_rename,
    state_dict_from_flax,
)
from gcd_tpu_torch.utils.config import instantiate_from_config, load_config
from tests.torch_port_helpers import (
    REPO,
    TINY_CONFIG,
    engine_params,
    engine_state_dict,
    rel_l2,
    tiny_batch,
)

B, T, H, W = 2, 2, 32, 48
UNET = "model.diffusion_model."


def _config():
    cfg = load_config(TINY_CONFIG)["model"]
    cfg["params"]["en_and_decode_n_samples_a_time"] = B * T  # one chunk: compiles sooner
    for emb in cfg["params"]["conditioner_config"]["params"]["emb_models"]:
        emb.pop("ucg_rate", None)
    return cfg


def _batch():
    clips = [tiny_batch(T, H, W, 50 + i) for i in range(B)]
    batch = {k: np.concatenate([c[k] for c in clips]) for k in clips[0]}
    batch["image_only_indicator"] = np.zeros((B, T), np.float32)
    batch["jpg"] = np.random.default_rng(60).uniform(-1, 1, (B * T, H, W, 3)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def setup():
    cfg = _config()
    jeng = j_instantiate(copy.deepcopy(cfg))
    batch = _batch()
    params = engine_params(jeng, batch, 70)
    emb_models = cfg["params"]["conditioner_config"]["params"]["emb_models"]
    port_cfg = copy.deepcopy(cfg)
    port_cfg["params"]["network_config"]["params"]["use_checkpoint"] = True
    engine = instantiate_from_config(port_cfg)
    engine.load_state_dict(engine_state_dict(params, emb_models, 71), strict=True)
    return jeng, params, batch, engine.eval()


def _torch_keys(tree, prefix):
    return {gcd_clip_rename(prefix + flax_path_to_torch_key(path)[0]): leaf
            for path, leaf in _iter_tree_paths(tree)}


def _keeping_grads(opt: optax.GradientTransformation) -> optax.GradientTransformation:
    """`opt`, whose state also holds the last gradients it was given."""
    def init(params):
        return opt.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = opt.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_step(setup):
    """JAX's whole `train_step`, once: (lr, metrics, the UNet's gradient and
    the new UNet / conditioner weights by torch key, the step's draws
    rebuilt from its key)."""
    jeng, params, batch, _ = setup
    lr = float(load_config(TINY_CONFIG)["model"]["base_learning_rate"])
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = _keeping_grads(make_optimizer(jeng, params, lr))
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32), None)
    new_state, metrics = jax.jit(lambda s, b, k: train_step(jeng, opt, s, b, k))(
        state, jbatch, key)
    new_params, grads = new_state.params, new_state.opt_state[1]["model"]

    k_enc, _, k_loss = jax.random.split(key, 3)
    posterior = np.concatenate([
        np.asarray(jax.random.normal(jax.random.fold_in(k_enc, i), (n, H // 8, W // 8, 4)))
        for i, n in enumerate((B * T,))])
    k_sigma, k_noise, _ = jax.random.split(k_loss, 3)
    draws = {"posterior": posterior,
             "sigma_rand": np.asarray(jax.random.normal(k_sigma, (B * T,))),
             "noise": np.asarray(jax.random.normal(k_noise, (B * T, H // 8, W // 8, 4)))}
    new_sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, new_params["model"]), UNET)
    new_sd.update(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, new_params["conditioner"]), "conditioner."))
    return dict(lr=lr, loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                global_step=int(metrics["global_step"]), draws=draws, new_sd=new_sd,
                grads=state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads), UNET))


def _check_step(jax_step, out, grads, before, now):
    """The step against JAX's: the loss 1e-5, the grad norm and the UNet's
    gradient 1e-4, the weights' change 1e-2 (module docstring)."""
    lr = jax_step["lr"]
    assert out["global_step"] == jax_step["global_step"] == 0
    assert abs(float(out["loss"]) - jax_step["loss"]) <= 1e-5 * abs(jax_step["loss"])
    assert rel_l2(float(out["grad_norm"]), jax_step["grad_norm"]) <= 1e-4
    want_grads = jax_step["grads"]
    names = sorted(want_grads)
    assert names == sorted(n for n in now if n.startswith(UNET))
    want = torch.cat([want_grads[n].flatten() for n in names])
    got = torch.cat([grads[n].flatten() for n in names])
    assert float(want.abs().max()) > 1e-3
    assert rel_l2(got.numpy(), want.numpy()) <= 1e-4
    new_sd = jax_step["new_sd"]
    for prefix in (UNET, "conditioner.embedders.5."):
        keys = sorted(k for k in new_sd if k.startswith(prefix))
        want_delta = torch.cat([(new_sd[k] - before[k]).flatten() for k in keys])
        got_delta = torch.cat([(now[k].detach() - before[k]).flatten() for k in keys])
        assert float(want_delta.abs().max()) > 0.5 * lr
        assert rel_l2(got_delta.numpy(), want_delta.numpy()) <= 1e-2
    frozen = [n for n in before if n.startswith(("first_stage_model.", "conditioner.embedders.0.",
                                                 "conditioner.embedders.3."))]
    assert frozen and all(torch.equal(now[n], before[n]) for n in frozen)


def test_train_step_matches_jax(setup, jax_step):
    _, _, batch, engine = setup
    trainer = Trainer(engine, jax_step["lr"])
    before = {n: p.detach().clone() for n, p in engine.named_parameters()}
    out = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                             draws={k: torch.from_numpy(np.array(v))
                                    for k, v in jax_step["draws"].items()})
    now = dict(engine.named_parameters())
    _check_step(jax_step, out, {n: p.grad for n, p in now.items() if p.grad is not None},
                before, now)


def _sharded_child(path: str, rank: int, port: int) -> None:
    """One of four processes at fsdp 2 x tensor 2: the port's engine on the
    file's weights, one train_step on its rows of the batch and of JAX's
    draws; process 0 writes the step's metrics, the UNet's gradient and the
    weights, gathered whole."""
    import torch.distributed as dist

    from gcd_tpu_torch.engine.trainer import take_rows
    from gcd_tpu_torch.parallel.mesh import create_mesh, unet_placements

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=4,
                            rank=rank)
    mesh = create_mesh(-1, 2, 2, "cpu")
    case = torch.load(path, weights_only=False)
    engine = instantiate_from_config(case["config"])
    engine.load_state_dict(case["state_dict"], strict=True)
    unet = engine.model.diffusion_model
    placements = unet_placements(unet, 2, 2, min_weight_size=2 ** 12)
    trainer = Trainer(engine.eval(), case["lr"], mesh=mesh, placements=placements)
    bt = B * T // mesh.batch_count
    lo, hi = mesh.batch_coordinate * bt, (mesh.batch_coordinate + 1) * bt
    out = trainer.train_step({k: torch.from_numpy(v[lo // T:hi // T] if k ==
                                                  "image_only_indicator" else v[lo:hi])
                              for k, v in case["batch"].items()},
                             draws=take_rows({k: torch.from_numpy(np.array(v))
                                              for k, v in case["draws"].items()}, lo, hi))
    grads = {n: trainer._whole(n, m.grad) for n, m in zip(trainer.trainable_names,
                                                           trainer.masters)}
    weights = trainer.module_state_dict()
    if rank == 0:
        torch.save({"out": {k: float(v) if torch.is_tensor(v) else v for k, v in out.items()},
                    "grads": grads, "weights": weights,
                    "sharded": sum(p.fsdp_dim is not None for p in placements.values()),
                    "cut": sum(p.tensor_dim is not None for p in placements.values())},
                   path + ".out")
    dist.destroy_process_group()


def test_sharded_train_step_matches_jax(setup, jax_step, tmp_path):
    """Four gloo processes at fsdp 2 x tensor 2 (the one JAX step above, as
    tests/test_parallel.py:153-184 holds JAX's sharded step to the
    single-device one), JAX's min_weight_size lowered to 2**12 so that the
    tiny UNet is sharded and cut; the same bounds as the one-process step."""
    _, params, batch, engine = setup
    cfg = _config()
    cfg["params"]["network_config"]["params"]["use_checkpoint"] = True
    emb_models = cfg["params"]["conditioner_config"]["params"]["emb_models"]
    before = engine_state_dict(params, emb_models, 71)
    path = str(tmp_path / "step.pt")
    torch.save({"config": cfg, "state_dict": before, "batch": batch, "lr": jax_step["lr"],
                "draws": jax_step["draws"]}, path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONSTARTUP", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", "from tests.test_torch_train_step import _sharded_child; "
         f"_sharded_child({path!r}, {rank}, {port})"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(4)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    got = torch.load(path + ".out", weights_only=False)
    assert got["sharded"] > 0 and got["cut"] > 0
    _check_step(jax_step, got["out"], got["grads"], before, got["weights"])


@pytest.mark.parametrize("strategy", ["everything", "time", "dummy"])
def test_trainable_sets_match_jax(setup, strategy):
    jeng, params, _, engine = setup
    jeng.ft_strategy = engine.ft_strategy = strategy
    try:
        mask = jeng.trainable_mask(params)
        names = engine.trainable_parameter_names()
    finally:
        jeng.ft_strategy = engine.ft_strategy = "everything"
    want = set()
    for tree_key, prefix in (("model", UNET), ("conditioner", "conditioner."),
                             ("first_stage", "first_stage_model.")):
        want |= {k for k, flag in _torch_keys(mask[tree_key], prefix).items() if flag}
    assert names == want
    unet = {n for n in names if n.startswith(UNET)}
    if strategy == "time":
        assert unet and all("time" in n for n in unet)
    if strategy == "dummy":  # the tiny UNet has no output_blocks.11
        assert not unet and names == {n for n in want if n.startswith("conditioner.")}


def test_dummy_strategy_trains_one_flagship_time_mixer():
    with torch.device("meta"):
        engine = instantiate_from_config(
            load_config(TINY_CONFIG.replace("smoke_kubric_tiny", "train_kubric_max90"))["model"])
    engine.ft_strategy = "dummy"
    assert engine.trainable_parameter_names() == {
        UNET + "output_blocks.11.1.time_mixer.mix_factor",
        "conditioner.embedders.5.proj.weight", "conditioner.embedders.5.proj.bias"}


def test_time_lora_is_later_work(setup):
    """time_lora, the strategy ported after the other three, trains the
    LoRA adapters of the 108 "time" projections and the trainable embedder,
    no base weight (tests/test_torch_training_options.py holds the set to
    JAX's mask)."""
    cfg = _config()
    cfg["params"]["ft_strategy"] = "time_lora"
    with torch.device("meta"):
        engine = instantiate_from_config(cfg)
    names = engine.trainable_parameter_names()
    unet = {n for n in names if n.startswith(UNET)}
    assert len(unet) == 2 * 108
    assert all(n.endswith((".lora_a", ".lora_b")) and "time" in n for n in unet)
    assert names - unet == {"conditioner.embedders.5.proj.weight",
                            "conditioner.embedders.5.proj.bias"}
    engine.ft_strategy = "nothing"
    with pytest.raises(NotImplementedError, match="nothing"):
        engine.trainable_parameter_names()

"""The training options of the port (engine/ema.py, engine/lr_schedule.py,
models/lora.py, gradient accumulation in engine/trainer.py, the loader's
process shard) against the JAX package.

configs/smoke_kubric_tiny.yaml (the tiny UNet, VAE and conditioner), two
videos of two 32x48 frames, fp32 on both sides, JAX at highest matmul
precision. The LoRA adapters are seeded nonzero (A and B) and carried across
with the base weights through io/convert.py. The trajectory is JAX's
`create_train_state` / `train_step` with time_lora, a LambdaLinearScheduler
warming up over 2 updates, MultiSteps over 2 micro-steps and EMA, for 4
micro-steps; the port gets JAX's draws rebuilt from each step's key, as in
tests/test_torch_train_step.py (ucg_rate 0: flax's make_rng draws cannot be
handed across). JAX's optimizer is completed with a stage that zeroes the
frozen leaves' updates: its `optax.masked` passes their gradients through,
and without it JAX's update adds the gradient to the frozen base UNet
(up to 1.7 in a weight here), against the mask's meaning and the reference.

Bounds: the merged forward 1e-5 relative L2 and the losses 1e-5 (the same
fp32 sums in another order), the adapters after each micro-step 1e-4, the
bound tests/test_torch_train_step.py holds the plain step's gradient to, and
each update's change to them 1e-2, the bound it holds the plain step's
change to (AdamW's change is ~lr per element, and the fp32 adapters round it
to their ulp in a different order of operations on each side); the EMA
1e-6 against JAX (the same three fp32 operations; XLA may contract two of
them) and bit for bit against the formula in plain torch.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gcd_tpu.data.loader import PrefetchLoader as JPrefetchLoader
from gcd_tpu.engine import ema as jema
from gcd_tpu.engine import lr_schedule as jsched
from gcd_tpu.engine.trainer import TrainState, create_train_state, make_schedule_fn, train_step
from gcd_tpu.models.lora import _set, apply_lora, lora_target_paths
from gcd_tpu.utils.config import instantiate_from_config as j_instantiate
from gcd_tpu_torch.data.loader import PrefetchLoader
from gcd_tpu_torch.engine import ema, lr_schedule
from gcd_tpu_torch.engine.trainer import Trainer
from gcd_tpu_torch.io.checkpoint import extract_ema_state_dict
from gcd_tpu_torch.io.convert import _iter_tree_paths, flax_path_to_torch_key, state_dict_from_flax
from gcd_tpu_torch.models.lora import LoRALinear, is_adapter, merge_lora_state_dict
from gcd_tpu_torch.utils.config import instantiate_from_config, load_config
from tests.torch_port_helpers import (
    TINY_CONFIG,
    engine_params,
    engine_state_dict,
    rel_l2,
    tiny_batch,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

B, T, H, W = 2, 2, 32, 48
UNET = "model.diffusion_model."
ACCUMULATE, MICRO_STEPS = 2, 4
SCHEDULER = {"target": "sgm.lr_scheduler.LambdaLinearScheduler",
             "params": {"warm_up_steps": [2], "cycle_lengths": [10], "f_start": [0.1],
                        "f_max": [1.0], "f_min": [0.5]}}


def _config():
    cfg = load_config(TINY_CONFIG)["model"]
    p = cfg["params"]
    p["en_and_decode_n_samples_a_time"] = B * T  # one chunk: compiles sooner
    p.update(ft_strategy="time_lora", use_ema=True, ema_decay_rate=0.999,
             scheduler_config=copy.deepcopy(SCHEDULER))
    for emb in p["conditioner_config"]["params"]["emb_models"]:
        emb.pop("ucg_rate", None)
    return cfg


def _batch():
    clips = [tiny_batch(T, H, W, 50 + i) for i in range(B)]
    batch = {k: np.concatenate([c[k] for c in clips]) for k in clips[0]}
    batch["image_only_indicator"] = np.zeros((B, T), np.float32)
    batch["jpg"] = np.random.default_rng(60).uniform(-1, 1, (B * T, H, W, 3)).astype(np.float32)
    return batch


def _lora_params(model, seed):
    """Seeded nonzero adapters for every JAX target, init_lora_params' tree."""
    rng = np.random.default_rng(seed)
    lora = {}
    for path in lora_target_paths(model):
        d_in, d_out = np.shape(_get(model, path))
        _set(lora, path[:-1] + ("lora_a",),
             (rng.normal(size=(d_in, 16)) / np.sqrt(d_in)).astype(np.float32))
        _set(lora, path[:-1] + ("lora_b",), (0.05 * rng.normal(size=(16, d_out))).astype(
            np.float32))
    return lora


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.fixture(scope="module")
def setup():
    cfg = _config()
    jeng = j_instantiate(copy.deepcopy(cfg))
    batch = _batch()
    params = engine_params(jeng, batch, 70)
    params["lora"] = _lora_params(params["model"], 72)
    emb_models = cfg["params"]["conditioner_config"]["params"]["emb_models"]
    sd = engine_state_dict(params, emb_models, 71)
    sd.update(state_dict_from_flax(params["lora"], UNET))
    port_cfg = copy.deepcopy(cfg)
    port_cfg["params"]["network_config"]["params"]["use_checkpoint"] = True
    engine = instantiate_from_config(port_cfg)
    engine.load_state_dict(sd, strict=True)
    return jeng, params, batch, engine.eval(), sd


def test_lora_targets_and_trainable_set_match_jax(setup):
    jeng, params, _, engine, _ = setup
    want = {UNET + flax_path_to_torch_key(path)[0] for path in lora_target_paths(params["model"])}
    heads = {f"{UNET}{name}.weight" for name, m in engine.model.diffusion_model.named_modules()
             if isinstance(m, LoRALinear)}
    assert len(want) == 108 and heads == want
    mask = jeng.trainable_mask(params)
    flagged = {UNET + flax_path_to_torch_key(path)[0]
               for path, flag in _iter_tree_paths(mask["lora"]) if flag}
    flagged |= {"conditioner." + flax_path_to_torch_key(path)[0]
                for path, flag in _iter_tree_paths(mask["conditioner"]) if flag}
    assert not any(flag for _, flag in _iter_tree_paths(mask["model"]))
    assert engine.trainable_parameter_names() == flagged
    assert sum(is_adapter(n) for n in flagged) == 2 * 108


def test_merged_forward_matches_jax(setup):
    jeng, params, _, engine, _ = setup
    net = jeng.network
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B * T, H // 8, W // 8, net.in_channels)).astype(np.float32)
    ts = rng.normal(size=(B * T,)).astype(np.float32)
    ctx = rng.normal(size=(B * T, 1, net.context_dim)).astype(np.float32)
    y = rng.normal(size=(B * T, net.adm_in_channels + net.aux_emb_dim)).astype(np.float32)
    ioi = np.zeros((B, T), np.float32)
    merged = jeng.effective_model_params(params)
    assert merged is not params["model"]
    unet = jax.jit(lambda p, *a: net.apply(
        {"params": p}, *a, num_video_frames=T, image_only_indicator=jnp.asarray(ioi)))
    ref = np.asarray(unet(merged, *map(jnp.asarray, (x, ts, ctx, y))))
    with torch.no_grad():
        out = engine.model.diffusion_model(
            torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(ts),
            torch.from_numpy(ctx), torch.from_numpy(y), num_video_frames=T,
            image_only_indicator=torch.from_numpy(ioi)).permute(0, 2, 3, 1).numpy()
    base = np.asarray(unet(params["model"], *map(jnp.asarray, (x, ts, ctx, y))))
    assert rel_l2(base, ref) > 1e-3  # the adapters move the output
    assert rel_l2(out, ref) <= 1e-5
    # The bundle's merge in weight space gives the same weights.
    folded = merge_lora_state_dict(setup[4])
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, apply_lora(
        params["model"], params["lora"])), UNET)
    assert not any(is_adapter(k) for k in folded)
    assert max(float((folded[k] - want[k]).abs().max()) for k in want) <= 1e-6


def _jax_draws(key):
    """The posterior, sigma and noise draws of JAX's engine.loss for `key`
    (one encoder chunk; tests/test_torch_train_step.py)."""
    k_enc, _, k_loss = jax.random.split(key, 3)
    k_sigma, k_noise, _ = jax.random.split(k_loss, 3)
    draws = {"posterior": jax.random.normal(jax.random.fold_in(k_enc, 0),
                                            (B * T, H // 8, W // 8, 4)),
             "sigma_rand": jax.random.normal(k_sigma, (B * T,)),
             "noise": jax.random.normal(k_noise, (B * T, H // 8, W // 8, 4))}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _adapters(tree):
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree), UNET)


def test_time_lora_schedule_accumulation_ema_trajectory_matches_jax(setup):
    jeng, params, batch, engine, _ = setup
    engine = copy.deepcopy(engine)
    lr = float(load_config(TINY_CONFIG)["model"]["base_learning_rate"])
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    schedule_fn = make_schedule_fn(jeng.scheduler_config, lr)
    state, opt = create_train_state(jeng, jparams, lr, schedule_fn=schedule_fn,
                                    accumulate_steps=ACCUMULATE)
    # optax.masked passes a masked-out leaf's gradient through as its update,
    # so JAX's step adds the gradient to the frozen base UNet. The reference
    # is that step with the frozen leaves' updates zeroed, as the mask means.
    frozen = jax.tree_util.tree_map(lambda m: not m, jeng.trainable_mask(jparams))
    opt = optax.chain(opt, optax.masked(optax.set_to_zero(), frozen))
    state = TrainState(jparams, opt.init(jparams), state.step, state.ema)
    step = jax.jit(lambda s, b, k: train_step(jeng, opt, s, b, k))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    trainer = Trainer(engine, lr, ACCUMULATE)
    names = [n for n in trainer.trainable_names if is_adapter(n)]
    base = {n: p.detach().clone() for n, p in engine.named_parameters()
            if n.startswith(UNET) and not is_adapter(n)}
    master = dict(zip(trainer.trainable_names, trainer.masters))
    before_j = _adapters(state.params["lora"])
    before_p = {n: master[n].clone() for n in names}
    lrs = []
    for i in range(MICRO_STEPS):
        key = jax.random.PRNGKey(100 + i)
        state, metrics = step(state, jbatch, key)
        lrs.append(trainer.optimizer.param_groups[0]["lr"])
        out = trainer.train_step(tbatch, draws=_jax_draws(key))
        assert out["global_step"] == int(metrics["global_step"]) == i
        assert abs(float(out["loss"]) - float(metrics["loss"])) <= 1e-5 * abs(
            float(metrics["loss"]))
        want = _adapters(state.params["lora"])
        got = torch.cat([master[n].flatten() for n in names])
        assert rel_l2(got.numpy(), torch.cat([want[n].flatten() for n in names]).numpy()) <= 1e-4
        if (i + 1) % ACCUMULATE:  # micro-steps 1, 3: nothing moves
            assert all(torch.equal(master[n], before_p[n]) for n in names)
            assert all(torch.equal(want[n], before_j[n]) for n in names)
        else:  # micro-steps 2, 4: one update of the mean gradient
            d_want = torch.cat([(want[n] - before_j[n]).flatten() for n in names])
            d_got = torch.cat([(master[n] - before_p[n]).flatten() for n in names])
            assert float(d_want.abs().max()) > 0.05 * lr
            assert rel_l2(d_got.numpy(), d_want.numpy()) <= 1e-2
            before_j, before_p = want, {n: master[n].clone() for n in names}
            assert all(torch.equal(dict(engine.named_parameters())[n], master[n])
                       for n in names)
    assert trainer.global_step == MICRO_STEPS and trainer.updates == MICRO_STEPS // ACCUMULATE
    sched = lr_schedule.LambdaLinearScheduler(**SCHEDULER["params"])
    assert lrs == [lr * sched(0), lr * sched(0), lr * sched(1), lr * sched(1)]
    # The frozen base is unchanged, and the EMA tracks it as JAX's does.
    now = dict(engine.named_parameters())
    assert all(torch.equal(now[n], w) for n, w in base.items())
    want_ema = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, state.ema.params), UNET)
    assert trainer.ema.num_updates == int(state.ema.num_updates) == MICRO_STEPS
    assert sorted(trainer.ema.params) == sorted(want_ema)
    for n, s in trainer.ema.params.items():
        torch.testing.assert_close(s, want_ema[n], rtol=1e-6, atol=1e-7)


def test_ema_matches_jax_over_12_updates(monkeypatch):
    monkeypatch.setattr(ema, "CHUNK_ELEMENTS", 40)  # several chunks
    rng = np.random.default_rng(9)
    shapes = {"model.diffusion_model.a.weight": (4, 6), "model.diffusion_model.b.bias": (30,),
              "model.diffusion_model.c.1.mix_factor": (1,)}
    init = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    jstate = jema.ema_init(jax.tree_util.tree_map(jnp.asarray, init), decay=0.999)
    state = ema.ema_init({n: torch.from_numpy(v) for n, v in init.items()}, decay=0.999)
    assert len(state.chunks) == 2
    plain = {n: torch.from_numpy(v.copy()) for n, v in init.items()}
    for i in range(12):  # the warm-up decay (1 + n) / (10 + n) stays below 0.999
        new = {n: (v + rng.normal(size=v.shape)).astype(np.float32) for n, v in init.items()}
        jstate = jema.ema_update(jstate, jax.tree_util.tree_map(jnp.asarray, new))
        w = ema.update_weight(state)
        ema.ema_update(state, [torch.from_numpy(new[n]) for n in shapes])
        for n in shapes:
            plain[n] = plain[n] - w * (plain[n] - torch.from_numpy(new[n]))
            assert torch.equal(state.params[n], plain[n])
            np.testing.assert_allclose(state.params[n].numpy(), np.asarray(jstate.params[n]),
                                       rtol=1e-6, atol=1e-7)
    assert state.num_updates == int(jstate.num_updates) == 12
    # LitEma's names, read back by the released-checkpoint path.
    sd = ema.lit_ema_state_dict(state)
    assert "model_ema.diffusion_modelc1mix_factor" in sd
    assert int(sd["model_ema.num_updates"]) == 12
    live = {n: torch.zeros(s) for n, s in shapes.items()}
    back = extract_ema_state_dict({**live, **sd})
    assert all(torch.equal(back[n], state.params[n]) for n in shapes)
    other = ema.ema_init(live, decay=0.5)
    ema.load_lit_ema_state_dict(other, sd)
    assert other.num_updates == 12 and np.float32(other.decay) == np.float32(0.999)
    assert all(torch.equal(other.params[n], state.params[n]) for n in shapes)


_SCHEDULERS = {
    "LambdaWarmUpCosineScheduler": dict(warm_up_steps=5, lr_min=0.1, lr_max=1.0,
                                        lr_start=0.01, max_decay_steps=40),
    "LambdaWarmUpCosineScheduler2": dict(warm_up_steps=[4, 3], f_min=[0.1, 0.2],
                                         f_max=[1.0, 0.8], f_start=[0.0, 0.05],
                                         cycle_lengths=[20, 45]),
    "LambdaLinearScheduler": dict(warm_up_steps=[4, 6], f_min=[0.1, 0.0], f_max=[1.0, 0.5],
                                  f_start=[0.01, 0.1], cycle_lengths=[25, 40]),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULERS))
def test_schedules_match_jax(name):
    """Steps 0..60 cross the warm-ups, the cycle boundaries and the end of
    the cosine's decay: JAX's `schedule` exactly. Past the last cycle's end,
    where that one indexes past its lists, JAX's trainer's traced
    `schedule_jnp` (float32)."""
    port = getattr(lr_schedule, name)(**_SCHEDULERS[name])
    ref = getattr(jsched, name)(**_SCHEDULERS[name])
    got = [float(port(n)) for n in range(61)]
    assert got == [float(ref.schedule(n)) for n in range(61)]
    assert len(set(got)) > 30
    past = range(70, 90, 7)
    np.testing.assert_allclose([float(port(n)) for n in past],
                               [float(ref.schedule_jnp(n)) for n in past], rtol=1e-6, atol=1e-7)
    cfg = instantiate_from_config({"target": f"sgm.lr_scheduler.{name}",
                                   "params": _SCHEDULERS[name]})
    assert type(cfg) is getattr(lr_schedule, name)


@pytest.mark.parametrize("shard", [(0, 2), (1, 2), (2, 4)])
def test_process_shard_matches_jax_loader(shard):
    class Items:
        def __len__(self):
            return 18

        def __getitem__(self, i):
            return {"idx": np.full((2,), i)}

    kwargs = dict(batch_size=4, shuffle=True, num_workers=2)
    port = PrefetchLoader(Items(), process_shard=shard, **kwargs)
    ref = JPrefetchLoader(Items(), process_shard=shard, **kwargs)
    for _ in range(2):  # two epochs, two shuffles
        got = [b["idx"] for b in port]
        want = [b["idx"] for b in ref]
        assert len(got) == len(want) == 4
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert all(a.shape == (2 * 4 // shard[1],) for a in got)
    with pytest.raises(ValueError, match="split evenly"):
        next(iter(PrefetchLoader(Items(), batch_size=3, process_shard=(0, 2))))

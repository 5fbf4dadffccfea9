"""The training step (port of gcd_tpu/engine/trainer.py `train_step`,
`make_schedule_fn` and `make_optimizer`).

    trainer = load_trainer("configs/train_kubric_max90.yaml")        # card, bf16
    metrics = trainer.train_step(batch, generator)  # {loss, grad_norm, global_step}
    trainer = load_trainer(path, device="cpu", dtype=torch.float32)  # the CPU tests

Precision is the usual mixed-precision recipe, in place of the JAX engine's
`compute_dtype` switch: the modules' weights stay in `dtype` (bf16 on the
card, the type the kernels take), and the trainer keeps fp32 master copies
of the trainable parameters, which the optimizer updates with fp32 state.
After each update it writes the masters back into the module weights. The
frozen parameters (the first-stage VAE, the embedders not marked
is_trainable, the UNet's outside `ft_strategy`, the whole base UNet under
`time_lora`) get requires_grad=False and no gradient.

The options of the engine's config and of `lightning.trainer`:
  * `scheduler_config`: update k (counted from 0) runs at base_lr *
    schedule(k) (engine/lr_schedule.py), optax's count under MultiSteps;
  * `accumulate_grad_batches` k: optax.MultiSteps. The masters' fp32 .grad
    holds the running mean of the micro-steps' gradients; the weights and
    the optimizer state stay as they are on micro-steps 1..k-1, and
    micro-step k applies one update of the mean. `global_step` counts
    micro-steps, as JAX's `state.step` does;
  * `use_ema`: an fp32 shadow of the whole UNet (engine/ema.py), updated
    after every micro-step from the fp32 master where a parameter has one
    and from its module weight where it does not (the frozen base under
    time_lora).

Data parallelism (parallel/distributed.py): each process runs its rows of
the global batch with the global batch's random numbers (`engine.draw`).
On every micro-step the fp32 gradient and the loss are averaged over the
processes in one flat buffer, one collective, so `loss` and `grad_norm`
are the global batch's, as JAX's `global_norm` of each micro-step's
gradient. The running mean of an accumulation is taken of the averaged
gradients, so every process holds the same mean at every micro-step and a
checkpoint taken at any of them (a periodic one or melk's) holds the
global mean. A k-step accumulation thus reduces k times an update; a
single reduction of the accumulated mean would leave the micro-steps'
grad norms per process.

`state_dict()` / `load_state_dict()` carry the masters, the optimizer
state, `global_step`, the update count, the accumulated gradient with the
micro-step, and the EMA under LitEma's names (io/checkpoint.py saves them
with the module weights); a load writes the masters back into the module
weights.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import torch

from gcd_tpu_torch.engine.build import engine_from_config
from gcd_tpu_torch.engine.ema import (ema_init, ema_update, lit_ema_state_dict,
                                      load_lit_ema_state_dict)
from gcd_tpu_torch.engine.engine import DiffusionEngine
from gcd_tpu_torch.io.checkpoint import UNET_PREFIX
from gcd_tpu_torch.models.lora import is_adapter
from gcd_tpu_torch.parallel import distributed
from gcd_tpu_torch.utils.config import (apply_dotlist, get_by_path, instantiate_from_config,
                                        load_config)

# main.py's learning rate when the config names none.
DEFAULT_LEARNING_RATE = 2e-5


def optimizer_from_config(optimizer_config: Optional[Dict], params: Iterable[torch.Tensor],
                          lr: float) -> torch.optim.Optimizer:
    """The torch.optim optimizer an engine's `optimizer_config` names (Adam,
    AdamW or SGD), with the semantics of gcd_tpu's
    `_optax_from_optimizer_config`: the config's `lr` gives way to `lr`,
    AdamW's weight decay defaults to 0.01, and unknown params raise."""
    cfg = optimizer_config or {"target": "torch.optim.AdamW"}
    target = cfg.get("target", "torch.optim.AdamW")
    p = dict(cfg.get("params") or {})
    betas = tuple(p.pop("betas", (0.9, 0.999)))
    eps = float(p.pop("eps", 1e-8))
    wd = p.pop("weight_decay", None)
    momentum = p.pop("momentum", None)
    p.pop("lr", None)
    if p:
        raise ValueError(f"unsupported optimizer params for {target}: {sorted(p)}")
    name = target.rsplit(".", 1)[-1].lower()
    if name in ("adam", "adamw") and momentum is not None:
        raise ValueError(f"{target} has no 'momentum' parameter")
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps,
                                weight_decay=float(wd or 0.0))
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                 weight_decay=0.01 if wd is None else float(wd))
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=float(momentum or 0.0),
                               weight_decay=float(wd or 0.0))
    raise ValueError(f"unsupported optimizer target {target!r}")


def _copy_state(key: str, value: Any, device: torch.device) -> Any:
    """A copy of one optimizer state entry: Adam's `step` stays where it is
    (on the CPU), the moments go to the masters' device."""
    if not isinstance(value, torch.Tensor):
        return value
    return value.clone() if key == "step" else value.to(device, copy=True)


def take_rows(draws: Dict, lo: int, hi: int) -> Dict:
    """Rows [lo, hi) of every tensor of a `draws` dict (engine.draw)."""
    return {k: take_rows(v, lo, hi) if isinstance(v, dict) else v[lo:hi]
            for k, v in draws.items()}


class Trainer:
    """A DiffusionEngine, fp32 masters of its trainable parameters, their
    optimizer, and the options above. `global_step` counts the micro-steps
    taken, `updates` the optimizer updates."""

    def __init__(self, engine: DiffusionEngine, learning_rate: float,
                 accumulate_grad_batches: int = 1):
        if accumulate_grad_batches < 1:
            raise ValueError(f"accumulate_grad_batches {accumulate_grad_batches} < 1")
        self.engine = engine
        names = engine.trainable_parameter_names()
        self.trainable_names: List[str] = []
        self.trainable: List[torch.nn.Parameter] = []
        named = dict(engine.named_parameters())
        for name, param in named.items():
            param.requires_grad_(name in names)
            if name in names:
                self.trainable_names.append(name)
                self.trainable.append(param)
        if not self.trainable:
            raise ValueError(f"ft_strategy {engine.ft_strategy!r} trains no parameter")
        self.masters = [p.detach().float().clone() for p in self.trainable]
        self.learning_rate = float(learning_rate)
        self.optimizer = optimizer_from_config(engine.optimizer_config, self.masters,
                                               learning_rate)
        self.schedule = (instantiate_from_config(engine.scheduler_config)
                         if engine.scheduler_config else None)
        self.accumulate = int(accumulate_grad_batches)
        # The micro-step's fp32 gradient and, last, its loss: one flat
        # buffer, reduced in one call. With accumulation the masters' .grad
        # is a second buffer, the running mean.
        device = self.masters[0].device
        total = sum(m.numel() for m in self.masters)
        self._reduced = torch.zeros(total + 1, device=device)
        self._grad, self._loss = self._reduced[:total], self._reduced[total:]
        self._grads = self._views(self._grad)
        self._acc = self._grad if self.accumulate == 1 else torch.zeros(total, device=device)
        for m, g in zip(self.masters, self._views(self._acc)):
            m.grad = g
        self.micro_step = 0
        self.updates = 0
        self.global_step = 0
        self._set_lr()
        self.ema = None
        if engine.use_ema:
            master_of = dict(zip(self.trainable_names, self.masters))
            unet = [n for n in named if n.startswith(UNET_PREFIX) and not is_adapter(n)]
            self.ema_sources = [master_of.get(n, named[n]) for n in unet]
            self.ema = ema_init({n: s for n, s in zip(unet, self.ema_sources)},
                                engine.ema_decay_rate)

    def _views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [v.view_as(m) for v, m in
                zip(flat.split([m.numel() for m in self.masters]), self.masters)]

    def lr_at(self, n: int) -> float:
        """The learning rate at optimizer update n: the base rate times the
        schedule's factor (the base rate without a schedule)."""
        if self.schedule is None:
            return self.learning_rate
        return self.learning_rate * float(self.schedule(n))

    def _set_lr(self) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_at(self.updates)

    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict] = None) -> Dict[str, Union[torch.Tensor, int]]:
        """One micro-step on `batch` (DiffusionEngine.loss; this process's
        rows of the global batch). The random numbers are `draws`, or this
        process's rows of the global batch's draws from `generator`.
        Returns {"loss": the global mean loss, "grad_norm": the norm of the
        global batch's gradient, "global_step": the micro-step's index}. The module weights' bf16 gradients stay on
        the parameters until the next micro-step."""
        rank, world = distributed.process_index(), distributed.process_count()
        if draws is None:
            bt = batch["jpg"].shape[0]
            draws = take_rows(self.engine.draw(bt * world, tuple(batch["jpg"].shape[1:3]),
                                               generator, batch["jpg"].device),
                              rank * bt, (rank + 1) * bt)
        for p in self.trainable:
            p.grad = None
        loss = self.engine.loss(batch, self.global_step, draws=draws).mean()
        loss.backward()
        update = self.micro_step == self.accumulate - 1
        with torch.no_grad():
            for p in self.trainable:
                if p.grad is None:  # not reached by the graph: zero, as jax.grad gives
                    p.grad = torch.zeros_like(p)
            torch._foreach_copy_(self._grads, [p.grad for p in self.trainable])
            self._loss.copy_(loss.detach().reshape(1))
            distributed.all_reduce_mean(self._reduced)
            loss = self._loss[0].clone()
            grad_norm = torch.linalg.vector_norm(self._grad)
            if self.accumulate > 1:
                # optax.MultiSteps: acc + (g - acc) / (i + 1).
                if self.micro_step == 0:
                    self._acc.copy_(self._grad)
                else:
                    self._acc.add_(self._grad.sub_(self._acc).div_(self.micro_step + 1))
            if update:
                self.optimizer.step()
                self.updates += 1
                self._set_lr()
                torch._foreach_copy_(self.trainable, self.masters)
            if self.ema is not None:
                ema_update(self.ema, self.ema_sources)
        self.micro_step = 0 if update else self.micro_step + 1
        metrics = {"loss": loss, "grad_norm": grad_norm, "global_step": self.global_step}
        self.global_step += 1
        return metrics

    def state_dict(self) -> Dict[str, Any]:
        """{"masters": {name: fp32 master}, "optimizer": the optimizer's
        state dict, "global_step", "updates"}, with "micro_step" and
        "accumulated_grad" (the flat running mean) under accumulation and
        "ema" (LitEma's names, engine/ema.py) with EMA; the tensors are the
        live ones, not copies."""
        state = {"masters": dict(zip(self.trainable_names, self.masters)),
                 "optimizer": self.optimizer.state_dict(), "global_step": self.global_step,
                 "updates": self.updates}
        if self.accumulate > 1:
            state.update(micro_step=self.micro_step, accumulated_grad=self._acc)
        if self.ema is not None:
            state["ema"] = lit_ema_state_dict(self.ema)
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy a state_dict() into this trainer (its tensors may be anywhere,
        mapped from a file included), then write the masters into the module
        weights. A state without the accumulation entries starts at
        micro-step 0; one without "updates" (the first format, one update a
        step) counts `global_step` updates; one without "ema" restarts the
        EMA from the restored weights."""
        masters = state["masters"]
        if list(masters) != self.trainable_names:
            raise KeyError("the checkpoint's trainable parameters are not this engine's")
        for m, saved in zip(self.masters, masters.values()):
            m.copy_(saved)
        opt = state["optimizer"]
        device = self.masters[0].device
        # Copies, so that the optimizer never updates the caller's tensors.
        self.optimizer.load_state_dict({
            "param_groups": opt["param_groups"],
            "state": {i: {k: _copy_state(k, v, device) for k, v in s.items()}
                      for i, s in opt["state"].items()}})
        self.global_step = int(state["global_step"])
        self.updates = int(state.get("updates", self.global_step))
        self.micro_step = int(state.get("micro_step", 0))
        if self.micro_step >= self.accumulate:
            raise ValueError(f"checkpoint at micro-step {self.micro_step} of "
                             f"{self.accumulate}")
        if self.accumulate > 1 and "accumulated_grad" in state:
            self._acc.copy_(state["accumulated_grad"])
        self._set_lr()
        torch._foreach_copy_(self.trainable, self.masters)
        if self.ema is not None:
            if "ema" in state:
                load_lit_ema_state_dict(self.ema, state["ema"])
            else:
                self.ema = ema_init(dict(zip(self.ema.params, self.ema_sources)),
                                    self.engine.ema_decay_rate)


def load_trainer(config_path: str, device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 overrides: Sequence[str] = ()) -> Trainer:
    """A Trainer for the engine of `config_path` with the `key.path=value`
    `overrides` (engine_from_config: CUDA unless device="cpu" is asked for,
    never a fallback), at the config's `model.base_learning_rate` and
    `lightning.trainer.accumulate_grad_batches`."""
    config = apply_dotlist(load_config(config_path), list(overrides))
    engine = engine_from_config(config["model"], device=device, dtype=dtype,
                                state_dict=state_dict)
    lr = config["model"].get("base_learning_rate")
    if lr is None:
        lr = engine.base_learning_rate or DEFAULT_LEARNING_RATE
    return Trainer(engine, float(lr),
                   int(get_by_path(config, "lightning.trainer.accumulate_grad_batches", 1)))

"""The training step (port of gcd_tpu/engine/trainer.py `train_step`).

    trainer = load_trainer("configs/train_kubric_max90.yaml")        # card, bf16
    metrics = trainer.train_step(batch, generator)  # {loss, grad_norm, global_step}
    trainer = load_trainer(path, device="cpu", dtype=torch.float32)  # the CPU tests

Precision is the usual mixed-precision recipe, in place of the JAX engine's
`compute_dtype` switch: the modules' weights stay in `dtype` (bf16 on the
card, the type the kernels take), and the trainer keeps fp32 master copies
of the trainable parameters, which the optimizer updates with fp32 state.
After each step it writes the masters back into the module weights. The
frozen parameters (the first-stage VAE, the embedders not marked
is_trainable, and the UNet's outside `ft_strategy`) get requires_grad=False
and no gradient.

`state_dict()` / `load_state_dict()` carry the masters, the optimizer state
and `global_step` (io/checkpoint.py saves them with the module weights); a
load writes the masters back into the module weights.

Not here yet: EMA, a learning-rate schedule, gradient accumulation, LoRA
and data parallelism (no shipped config uses the first four).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Union

import torch

from gcd_tpu_torch.engine.build import load_engine
from gcd_tpu_torch.engine.engine import DiffusionEngine
from gcd_tpu_torch.utils.config import load_config

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


class Trainer:
    """A DiffusionEngine, fp32 masters of its trainable parameters, and
    their optimizer. `global_step` counts the steps taken."""

    def __init__(self, engine: DiffusionEngine, learning_rate: float):
        self.engine = engine
        names = engine.trainable_parameter_names()
        self.trainable_names: List[str] = []
        self.trainable: List[torch.nn.Parameter] = []
        for name, param in engine.named_parameters():
            param.requires_grad_(name in names)
            if name in names:
                self.trainable_names.append(name)
                self.trainable.append(param)
        self.masters = [p.detach().float().clone() for p in self.trainable]
        self.optimizer = optimizer_from_config(engine.optimizer_config, self.masters,
                                               learning_rate)
        self.global_step = 0

    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict] = None) -> Dict[str, Union[torch.Tensor, int]]:
        """One optimization step on `batch` (DiffusionEngine.loss). Returns
        {"loss": the mean loss, "grad_norm": the global L2 norm of the
        trainable gradients, "global_step": the step's index}. The module
        weights' bf16 gradients stay on the parameters until the next step."""
        for p in self.trainable:
            p.grad = None
        loss = self.engine.loss(batch, self.global_step, generator, draws).mean()
        loss.backward()
        for p, m in zip(self.trainable, self.masters):
            if p.grad is None:  # not reached by the graph: zero, as jax.grad gives
                p.grad = torch.zeros_like(p)
            m.grad = p.grad.float()
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(m.grad) for m in self.masters]))
        self.optimizer.step()
        with torch.no_grad():
            for p, m in zip(self.trainable, self.masters):
                p.copy_(m)
                m.grad = None
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
                   "global_step": self.global_step}
        self.global_step += 1
        return metrics


    def state_dict(self) -> Dict[str, Any]:
        """{"masters": {name: fp32 master}, "optimizer": the optimizer's
        state dict, "global_step"}; the tensors are the live ones, not copies."""
        return {"masters": dict(zip(self.trainable_names, self.masters)),
                "optimizer": self.optimizer.state_dict(), "global_step": self.global_step}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy a state_dict() into this trainer (its tensors may be anywhere,
        mapped from a file included), then write the masters into the module
        weights."""
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
        for p, m in zip(self.trainable, self.masters):
            p.copy_(m)


def load_trainer(config_path: str, device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None) -> Trainer:
    """A Trainer for the engine of `config_path` (load_engine: CUDA unless
    device="cpu" is asked for, never a fallback), at the config's
    `model.base_learning_rate`."""
    engine = load_engine(config_path, device=device, dtype=dtype, state_dict=state_dict)
    lr = load_config(config_path)["model"].get("base_learning_rate")
    if lr is None:
        lr = engine.base_learning_rate or DEFAULT_LEARNING_RATE
    return Trainer(engine, float(lr))

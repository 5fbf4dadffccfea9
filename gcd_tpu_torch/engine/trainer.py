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

The fsdp and tensor axes (parallel/mesh.py; `Trainer(..., mesh=,
placements=)`, the entry's --mesh_fsdp / --mesh_tensor):
  * tensor: the UNet's cut projections are sliced to the rank's share
    before anything else (parallel/tensor.py `cut_unet`); their masters,
    gradients, Adam moments and EMA shadows are shares too;
  * fsdp: `torch.distributed.fsdp.fully_shard` (FSDP2) on every
    VideoResBlock and SpatialVideoTransformer of the UNet and on the UNet,
    over the fsdp axis (HSDP, replicated over data, when data > 1), with
    each parameter's dimension from the placement rule
    (`shard_placement_fn`) and MixedPrecisionPolicy(param_dtype=the
    engine's dtype, reduce_dtype=float32). The sharded parameters are fp32
    and are their own masters: the trainer's master is a view of the
    rank's shard, so Adam's state is sharded with it. The parameters the
    rule leaves replicated (below min_weight_size, the excluded embedding
    MLPs, no divisible dimension) are FSDP2's `ignored_params`: they keep
    the module dtype and an fp32 master, and their gradients are averaged
    over data x fsdp in the flat buffer above, with the loss. That keeps
    one path for every replicated parameter (the conditioner's trainable
    embedder included) and FSDP2 only for what it shards;
  * the logged loss and grad_norm stay the global batch's (the squared
    norm of the shards summed over fsdp and, for cut parameters, over
    tensor), accumulation the MultiSteps mean of each rank's shards, the
    EMA updated in place over each rank's shares;
  * the tensor-cut shares and the fsdp shards are gathered into whole
    tensors for a checkpoint (`state_dict`, `module_state_dict`: a
    collective, every process calls it) and cut again on a load, so a
    checkpoint has one format whatever the mesh and any mesh restores it.
Without a mesh (or with fsdp = tensor = 1) nothing of this runs: the
masters are copies and the flat buffer holds every gradient, as above.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from torch.distributed.tensor import DTensor

from gcd_tpu_torch.engine.build import engine_from_config
from gcd_tpu_torch.engine.ema import (ema_init, ema_update, lit_ema_state_dict,
                                      load_lit_ema_state_dict)
from gcd_tpu_torch.engine.engine import DiffusionEngine
from gcd_tpu_torch.io.checkpoint import UNET_PREFIX
from gcd_tpu_torch.models.lora import is_adapter
from gcd_tpu_torch.models.resblock import VideoResBlock
from gcd_tpu_torch.models.video_attention import SpatialVideoTransformer
from gcd_tpu_torch.parallel import distributed
from gcd_tpu_torch.parallel.mesh import REPLICATED, Mesh, Placement, unet_placements
from gcd_tpu_torch.parallel.tensor import cut_unet
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


def _local(t: torch.Tensor) -> torch.Tensor:
    """The rank's shard of an FSDP parameter (a view of FSDP's storage, so
    in-place updates reach the next all-gather); any other tensor as it is."""
    return t.detach().to_local() if isinstance(t, DTensor) else t


def fully_shard_unet(unet: torch.nn.Module, placements: Dict[str, Placement], mesh: Mesh,
                     dtype: torch.dtype, masters: bool = True) -> None:
    """FSDP2 on the UNet's blocks and root over the mesh's fsdp axis: each
    parameter with an fsdp dimension becomes a shard on it, gathered in
    `dtype` for the forward; the others are ignored (kept as they are). The
    shards are fp32, the trainer's masters, or with `masters=False` (a
    sampling engine, forward only) keep the parameters' own dtype."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor import Shard

    dims = {}
    with torch.no_grad():
        for name, p in unet.named_parameters():
            dim = placements.get(name, REPLICATED).fsdp_dim
            if dim is not None:
                # FSDP2 takes contiguous parameters only: the K7 convs'
                # channels_last weights are relaid out after the gather
                # (models/resblock.py).
                p.data = (p.data.float() if masters else p.data).contiguous()
                dims[id(p)] = dim
    ignored = {p for p in unet.parameters() if id(p) not in dims}
    # A VideoResBlock returns a reshaped view; the UNet applies no in-place
    # op to a block's output (models/unet.py), which is what FSDP2 warns of.
    warnings.filterwarnings("ignore", message="FSDP2-wrapped module .* returned a view")
    kwargs = dict(mesh=mesh.fsdp_device_mesh(), reshard_after_forward=True,
                  shard_placement_fn=lambda p: Shard(dims[id(p)]), ignored_params=ignored,
                  mp_policy=MixedPrecisionPolicy(param_dtype=dtype, reduce_dtype=torch.float32,
                                                 cast_forward_inputs=False))
    for m in list(unet.modules()):
        if isinstance(m, (VideoResBlock, SpatialVideoTransformer)):
            fully_shard(m, **kwargs)
    fully_shard(unet, **kwargs)


class Trainer:
    """A DiffusionEngine, fp32 masters of its trainable parameters, their
    optimizer, and the options above. `global_step` counts the micro-steps
    taken, `updates` the optimizer updates. With a `mesh` and the UNet's
    `placements` (parallel/mesh.py unet_placements, by name under the UNet)
    the UNet is cut and sharded as they say."""

    def __init__(self, engine: DiffusionEngine, learning_rate: float,
                 accumulate_grad_batches: int = 1, mesh: Optional[Mesh] = None,
                 placements: Optional[Dict[str, Placement]] = None):
        if accumulate_grad_batches < 1:
            raise ValueError(f"accumulate_grad_batches {accumulate_grad_batches} < 1")
        self.engine = engine
        self.mesh = mesh
        names = engine.trainable_parameter_names()
        for name, param in engine.named_parameters():
            param.requires_grad_(name in names)
        unet = engine.model.diffusion_model
        self.module_dtype = unet.time_embed[0].weight.dtype
        placements = {n: pl for n, pl in (placements or {}).items() if pl != REPLICATED}
        self.layouts = {UNET_PREFIX + n: pl for n, pl in placements.items()}
        if self.layouts and mesh is None:
            raise ValueError("parameter placements need a mesh")
        if any(pl.tensor_dim is not None for pl in placements.values()):
            cut_unet(unet, placements, mesh.coords["tensor"], mesh.tensor, mesh.tensor_group)
        if any(pl.fsdp_dim is not None for pl in placements.values()):
            fully_shard_unet(unet, placements, mesh, self.module_dtype)
        self.trainable_names: List[str] = []
        self.trainable: List[torch.nn.Parameter] = []
        named = dict(engine.named_parameters())
        for name, param in named.items():
            if name in names:
                self.trainable_names.append(name)
                self.trainable.append(param)
        if not self.trainable:
            raise ValueError(f"ft_strategy {engine.ft_strategy!r} trains no parameter")
        with torch.no_grad():
            self.masters = [_local(p) if isinstance(p, DTensor)
                            else p.detach().float().clone() for p in self.trainable]
        self.learning_rate = float(learning_rate)
        self.optimizer = optimizer_from_config(engine.optimizer_config, self.masters,
                                               learning_rate)
        self.schedule = (instantiate_from_config(engine.scheduler_config)
                         if engine.scheduler_config else None)
        self.accumulate = int(accumulate_grad_batches)
        # The micro-step's fp32 gradient and, last, its loss: one flat
        # buffer, reduced in one call. Under fsdp the shards FSDP has
        # reduced already sit in a second buffer. Within each, the
        # parameters not cut over tensor come first. With accumulation the
        # masters' .grad are views of mirror buffers, the running mean.
        device = self.masters[0].device
        sharded = [isinstance(p, DTensor) for p in self.trainable]
        cut = [self.layout(n).tensor_dim is not None for n in self.trainable_names]
        order = sorted(range(len(self.masters)), key=lambda i: (sharded[i], cut[i]))
        numel = [m.numel() for m in self.masters]
        rep = [i for i in order if not sharded[i]]
        shd = [i for i in order if sharded[i]]
        n_rep, n_shd = sum(numel[i] for i in rep), sum(numel[i] for i in shd)
        self._reduced = torch.zeros(n_rep + 1, device=device)
        self._grad, self._loss = self._reduced[:n_rep], self._reduced[n_rep:]
        self._shard_grad = torch.zeros(n_shd, device=device)
        # [lo, hi) of the uncut and the cut parameters in each buffer.
        self._split = (sum(numel[i] for i in rep if not cut[i]),
                       sum(numel[i] for i in shd if not cut[i]))
        self._simple_norm = not self.layouts
        self._grads = self._views([self._grad, self._shard_grad], [rep, shd])
        if self.accumulate == 1:
            self._pairs = []
            acc = self._grads
        else:
            self._pairs = [(self._grad, torch.zeros(n_rep, device=device)),
                           (self._shard_grad, torch.zeros(n_shd, device=device))]
            acc = self._views([a for _, a in self._pairs], [rep, shd])
        self._acc_views = acc
        for m, g in zip(self.masters, acc):
            m.grad = g
        self._rep_params = [self.trainable[i] for i in sorted(rep)]
        self._rep_masters = [self.masters[i] for i in sorted(rep)]
        self._batch_group = mesh.batch_group if mesh is not None else None
        self.micro_step = 0
        self.updates = 0
        self.global_step = 0
        self._set_lr()
        self.ema = None
        if engine.use_ema:
            master_of = dict(zip(self.trainable_names, self.masters))
            unet_names = [n for n in named if n.startswith(UNET_PREFIX) and not is_adapter(n)]
            self.ema_sources = [master_of.get(n, _local(named[n])) for n in unet_names]
            self.ema = ema_init({n: s for n, s in zip(unet_names, self.ema_sources)},
                                engine.ema_decay_rate)

    def _views(self, flats: List[torch.Tensor], index: List[List[int]]) -> List[torch.Tensor]:
        """Views shaped as the masters (in their order) into `flats`, the
        masters of index[k] laid out in flats[k] in that order."""
        out: List[Optional[torch.Tensor]] = [None] * len(self.masters)
        for flat, idx in zip(flats, index):
            for i, v in zip(idx, flat.split([self.masters[i].numel() for i in idx])):
                out[i] = v.view_as(self.masters[i])
        return out

    def layout(self, name: str) -> Placement:
        """The placement of engine parameter `name` (replicated unless the
        UNet is cut or sharded)."""
        return self.layouts.get(name, REPLICATED)

    def lr_at(self, n: int) -> float:
        """The learning rate at optimizer update n: the base rate times the
        schedule's factor (the base rate without a schedule)."""
        if self.schedule is None:
            return self.learning_rate
        return self.learning_rate * float(self.schedule(n))

    def _set_lr(self) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_at(self.updates)

    def _grad_norm(self) -> torch.Tensor:
        """The norm of the global batch's gradient: the replicated part
        counted once, the fsdp shards summed over fsdp, the tensor-cut
        shares over tensor."""
        if self._simple_norm:
            return torch.linalg.vector_norm(self._grad)
        def sq(t):
            return torch.linalg.vector_norm(t).square()

        a, b = self._split
        rep_uncut, rep_cut = sq(self._grad[:a]), sq(self._grad[a:])
        shards = torch.stack([sq(self._shard_grad[:b]), sq(self._shard_grad[b:])])
        if self.mesh.fsdp > 1:
            torch.distributed.all_reduce(shards, group=self.mesh.fsdp_group)
        cut = (rep_cut + shards[1]).reshape(1)
        if self.mesh.tensor > 1:
            torch.distributed.all_reduce(cut, group=self.mesh.tensor_group)
        return torch.sqrt(rep_uncut + shards[0] + cut[0])

    def train_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict] = None) -> Dict[str, Union[torch.Tensor, int]]:
        """One micro-step on `batch` (DiffusionEngine.loss; this process's
        rows of the global batch). The random numbers are `draws`, or this
        process's rows of the global batch's draws from `generator`.
        Returns {"loss": the global mean loss, "grad_norm": the norm of the
        global batch's gradient, "global_step": the micro-step's index}. The module weights' bf16 gradients stay on
        the parameters until the next micro-step."""
        if self.mesh is not None:
            block, blocks = self.mesh.batch_coordinate, self.mesh.batch_count
        else:
            block, blocks = distributed.process_index(), distributed.process_count()
        if draws is None:
            bt = batch["jpg"].shape[0]
            draws = take_rows(self.engine.draw(bt * blocks, tuple(batch["jpg"].shape[1:3]),
                                               generator, batch["jpg"].device),
                              block * bt, (block + 1) * bt)
        for p in self.trainable:
            p.grad = None
        loss = self.engine.loss(batch, self.global_step, draws=draws).mean()
        loss.backward()
        update = self.micro_step == self.accumulate - 1
        with torch.no_grad():
            for p in self.trainable:
                if p.grad is None:  # not reached by the graph: zero, as jax.grad gives
                    p.grad = torch.zeros_like(p)
            torch._foreach_copy_(self._grads, [_local(p.grad) for p in self.trainable])
            self._loss.copy_(loss.detach().reshape(1))
            distributed.all_reduce_mean(self._reduced, self._batch_group)
            loss = self._loss[0].clone()
            grad_norm = self._grad_norm()
            if self.micro_step == 0:
                for g, acc in self._pairs:  # optax.MultiSteps: acc + (g - acc) / (i + 1)
                    acc.copy_(g)
            else:
                for g, acc in self._pairs:
                    acc.add_(g.sub_(acc).div_(self.micro_step + 1))
            if update:
                self.optimizer.step()
                self.updates += 1
                self._set_lr()
                torch._foreach_copy_(self._rep_params, self._rep_masters)
            if self.ema is not None:
                ema_update(self.ema, self.ema_sources)
        self.micro_step = 0 if update else self.micro_step + 1
        metrics = {"loss": loss, "grad_norm": grad_norm, "global_step": self.global_step}
        self.global_step += 1
        return metrics

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Parameter `name`'s share `t` gathered whole, on the CPU (a
        collective under a mesh); `t` itself when nothing is cut or sharded."""
        if not self.layouts:
            return t
        return self.mesh.gather(t, self.layout(name)).cpu()

    def _share(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This process's share of parameter `name`'s whole tensor `t`."""
        return self.mesh.local(t, self.layout(name)) if self.layouts else t

    def state_dict(self) -> Dict[str, Any]:
        """{"masters": {name: fp32 master}, "optimizer": the optimizer's
        state dict, "global_step", "updates"}, with "micro_step" and
        "accumulated_grad" (the flat running mean) under accumulation and
        "ema" (LitEma's names, engine/ema.py) with EMA; the tensors are the
        live ones, not copies. Under a mesh that cuts or shards the UNet,
        every process calls it (a collective) and gets the whole tensors,
        CPU copies, in the one-process format."""
        names = self.trainable_names
        opt = self.optimizer.state_dict()
        if self.layouts:
            opt = {"param_groups": opt["param_groups"], "state": {
                i: {k: self._whole(names[i], v) if self._is_moment(i, v, False) else v
                    for k, v in st.items()} for i, st in opt["state"].items()}}
        state = {"masters": {n: self._whole(n, m) for n, m in zip(names, self.masters)},
                 "optimizer": opt, "global_step": self.global_step, "updates": self.updates}
        if self.accumulate > 1:
            acc = (torch.cat([self._whole(n, a).flatten() for n, a in
                              zip(names, self._acc_views)]) if self.layouts
                   else self._pairs[0][1])
            state.update(micro_step=self.micro_step, accumulated_grad=acc)
        if self.ema is not None:
            state["ema"] = lit_ema_state_dict(self.ema, self._whole)
        return state

    def _is_moment(self, i: int, v: Any, whole: bool) -> bool:
        """Whether optimizer state `v` of parameter i is shaped like it
        (a moment; `whole`: like the whole parameter)."""
        shape = tuple(self.masters[i].shape)
        if whole:
            shape = self.mesh.full_shape(shape, self.layout(self.trainable_names[i]))
        return isinstance(v, torch.Tensor) and v.dim() > 0 and tuple(v.shape) == shape

    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        """The engine's state dict with its cut and sharded parameters
        gathered whole in the module dtype (a collective under a mesh that
        cuts or shards, CPU copies); engine.state_dict() otherwise."""
        sd = self.engine.state_dict()
        if not self.layouts:
            return sd
        return {k: self._whole(k, _local(v)).to(self.module_dtype) if k in self.layouts else v
                for k, v in sd.items()}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy a state_dict() into this trainer (its tensors may be anywhere,
        mapped from a file included), then write the masters into the module
        weights. A state without the accumulation entries starts at
        micro-step 0; one without "updates" (the first format, one update a
        step) counts `global_step` updates; one without "ema" restarts the
        EMA from the restored weights. Under a mesh each process takes its
        shares of the whole tensors."""
        masters = state["masters"]
        names = self.trainable_names
        if list(masters) != names:
            raise KeyError("the checkpoint's trainable parameters are not this engine's")
        for n, m, saved in zip(names, self.masters, masters.values()):
            m.copy_(self._share(n, saved))
        opt = state["optimizer"]
        device = self.masters[0].device
        # Copies, so that the optimizer never updates the caller's tensors.
        self.optimizer.load_state_dict({
            "param_groups": opt["param_groups"],
            "state": {i: {k: _copy_state(k, self._share(names[int(i)], v)
                                         if self.layouts and self._is_moment(int(i), v, True)
                                         else v, device)
                          for k, v in s.items()}
                      for i, s in opt["state"].items()}})
        self.global_step = int(state["global_step"])
        self.updates = int(state.get("updates", self.global_step))
        self.micro_step = int(state.get("micro_step", 0))
        if self.micro_step >= self.accumulate:
            raise ValueError(f"checkpoint at micro-step {self.micro_step} of "
                             f"{self.accumulate}")
        if self.accumulate > 1 and "accumulated_grad" in state:
            flat = state["accumulated_grad"]
            if self.layouts:
                shapes = [self.mesh.full_shape(m.shape, self.layout(n))
                          for n, m in zip(names, self.masters)]
                whole = flat.split([math.prod(s) for s in shapes])
                for n, a, w, s in zip(names, self._acc_views, whole, shapes):
                    a.copy_(self._share(n, w.view(s)))
            else:
                self._pairs[0][1].copy_(flat)
        self._set_lr()
        torch._foreach_copy_(self._rep_params, self._rep_masters)
        if self.ema is not None:
            if "ema" in state:
                load_lit_ema_state_dict(self.ema, state["ema"], self._share)
            else:
                self.ema = ema_init(dict(zip(self.ema.params, self.ema_sources)),
                                    self.engine.ema_decay_rate)


def load_trainer(config_path: str, device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 overrides: Sequence[str] = (), mesh: Optional[Mesh] = None,
                 rule: Optional[Tuple[int, int]] = None) -> Trainer:
    """A Trainer for the engine of `config_path` with the `key.path=value`
    `overrides` (engine_from_config: CUDA unless device="cpu" is asked for,
    never a fallback), at the config's `model.base_learning_rate` and
    `lightning.trainer.accumulate_grad_batches`. With a `mesh` the UNet is
    placed by parallel/mesh.py's rule at `rule` = (fsdp, tensor), the mesh's
    own sizes unless given (a smaller mesh then holds a larger mesh's
    placement: a one-card run of the fsdp path)."""
    config = apply_dotlist(load_config(config_path), list(overrides))
    engine = engine_from_config(config["model"], device=device, dtype=dtype,
                                state_dict=state_dict)
    lr = config["model"].get("base_learning_rate")
    if lr is None:
        lr = engine.base_learning_rate or DEFAULT_LEARNING_RATE
    placements = None
    if mesh is not None:
        fsdp, tensor = rule or (mesh.fsdp, mesh.tensor)
        placements = unet_placements(engine.model.diffusion_model, fsdp, tensor)
    return Trainer(engine, float(lr),
                   int(get_by_path(config, "lightning.trainer.accumulate_grad_batches", 1)),
                   mesh=mesh, placements=placements)

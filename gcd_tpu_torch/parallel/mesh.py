"""The process mesh and the placement rules (the port's own copy of
gcd_tpu/parallel/mesh.py).

A mesh of N processes has the JAX package's axes ("data", "fsdp",
"tensor"), row-major: process r sits at data r // (F*TP), fsdp
(r // TP) % F, tensor r % TP, as `create_mesh(data=-1, ...)` reshapes the
device list. The global batch splits over data x fsdp (make_batch_shardings):
the processes of one tensor group load and draw the same rows
(`Mesh.batch_coordinate`).

The parameters are placed as `make_param_shardings` places them:
  * fsdp: a parameter of at least `min_weight_size` elements is sharded
    over its largest dimension that the fsdp size divides, the first such
    on a tie (`_choose_fsdp_dim`); the per-video embedding MLPs stay
    replicated whatever their size (_FSDP_EXCLUDE_SUBSTRINGS);
  * tensor: Megatron's cut (`_tp_spec`): to_q / to_k / to_v on their
    output features, to_out.0 and the feed-forward's net.2 on their input
    features, their biases replicated (added after the reduction); a cut
    parameter of at least `min_weight_size` elements is also sharded over
    fsdp on its largest other divisible dimension.
The JAX rule reads flax layouts ((in, out) kernels, HWIO convs) and picks the
first largest dimension, so it is applied here to the flax-layout shape
that io/convert.py maps each torch key from, and the chosen dimension is
mapped back through that layout.

Where the port's placement departs from JAX's, and why:
  * an attention layer is cut only where its head count divides by the
    tensor size, so that K1, K6 and K2 see whole heads (JAX cuts by feature
    count and GSPMD re-gathers the split heads); on the flagship at TP = 2
    this leaves ds1's 5-head layers replicated, at TP = 4 ds1's and ds2's;
  * the feed-forward is cut where its inner size splits into multiples of
    K3's INNER_TILE, and then net.0.proj is cut too: each rank keeps its
    share of the value rows and of the gate rows, [value_r | gate_r], so K3
    computes only that rank's columns of h (JAX leaves the fused
    [value | gate] projection uncut, mesh.py:97-104);
  * a LoRA adapter of a cut projection is cut with it (B on the output
    features of a column cut, A on the input features of a row cut), so
    the merged weight is the rank's share of the merged full weight.
The numbers are the same either way.

Sampling (engine/serving.py) uses the same mesh: the batch group of this
process's tensor coordinate all-gathers the denoised rows, and the frame
groups (`frame_groups`, parallel/frames.py's row rule) re-lay a video
block's activations where its frames meet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gcd_tpu_torch.ops.fused_mlp import INNER_TILE

AXES = ("data", "fsdp", "tensor")
# JAX's default `min_weight_size`: smaller parameters stay replicated. The
# entry reads it at call time, so a test may lower it before it builds.
MIN_WEIGHT_SIZE = 2 ** 18
# Parameter-name substrings that stay replicated whatever their size (JAX's
# _FSDP_EXCLUDE_SUBSTRINGS: the time / label / aux / per-block embedding
# MLPs, which work on a few rows per video).
FSDP_EXCLUDE_SUBSTRINGS = ("time_embed", "label_emb", "aux_label_emb", "emb_layers",
                           "time_pos_embed")
# The projections of an attention layer (models/attention.py _Projections)
# and of a feed-forward (models/layers.py FeedForward), by module name.
COLUMN_PROJECTIONS = ("to_q", "to_k", "to_v")
ROW_PROJECTION = "to_out.0"
FF_UP, FF_DOWN = "net.0.proj", "net.2"


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a parameter lives, in torch layout: `fsdp_dim` is sharded over
    the fsdp axis, `tensor_dim` cut over the tensor axis; a `tensor_blocks`
    of 2 cuts each half of that dimension (the [value | gate] rows of
    net.0.proj). None: not on that axis."""
    fsdp_dim: Optional[int] = None
    tensor_dim: Optional[int] = None
    tensor_blocks: int = 1


REPLICATED = Placement()


def _split(name: str) -> Tuple[str, str]:
    """(module name, parameter name) of a parameter key."""
    module, _, leaf = name.rpartition(".")
    return module, leaf


def _flax_perm(name: str, ndim: int) -> Tuple[int, ...]:
    """perm with torch_shape[j] == flax_shape[perm[j]] for the parameter
    `name` (io/convert.py torch_layout_from_flax: Linear (in, out) ->
    (out, in), HWIO -> OIHW, DHWIO -> OIDHW; norms, biases and direct
    parameters such as the LoRA adapters keep their layout)."""
    if _split(name)[1] == "weight":
        if ndim == 2:
            return (1, 0)
        if ndim == 4:
            return (3, 2, 0, 1)
        if ndim == 5:
            return (4, 3, 0, 1, 2)
    return tuple(range(ndim))


def _fsdp_dim(name: str, shape: Tuple[int, ...], fsdp: int, min_weight_size: int,
              tensor_dim: Optional[int]) -> Optional[int]:
    """JAX's fsdp dimension (torch layout) of a parameter whose tensor cut is
    `tensor_dim`: the first largest dimension, in flax order, other than
    the cut one, that `fsdp` divides."""
    if fsdp <= 1 or int(np.prod(shape)) < min_weight_size:
        return None
    perm = _flax_perm(name, len(shape))
    best, best_size = None, 0
    for flax_dim in range(len(shape)):
        dim = perm.index(flax_dim)
        if dim != tensor_dim and shape[dim] % fsdp == 0 and shape[dim] > best_size:
            best, best_size = dim, shape[dim]
    return best


def ff_cut(inner: int, tensor: int) -> bool:
    """Whether a feed-forward of `inner` GEGLU columns is cut over `tensor`
    ranks: each rank's share a multiple of K3's INNER_TILE."""
    return tensor > 1 and inner % (tensor * INNER_TILE) == 0


def _tensor_cut(name: str, shape: Tuple[int, ...], tensor: int,
                heads: Optional[int]) -> Tuple[Optional[int], int]:
    """(tensor_dim, tensor_blocks) of the port's Megatron cut."""
    if tensor <= 1:
        return None, 1
    module, leaf = _split(name)
    parent = module.rsplit(".", 1)[-1]
    if module.endswith("." + ROW_PROJECTION) or parent in COLUMN_PROJECTIONS:
        if heads is None or heads % tensor:
            return None, 1
        if parent in COLUMN_PROJECTIONS:
            return {"weight": 0, "lora_b": 1}.get(leaf), 1
        return {"weight": 1, "lora_a": 0}.get(leaf), 1
    if module.endswith("." + FF_UP):
        inner = {"weight": shape[0] // 2, "bias": shape[0] // 2,
                 "lora_b": shape[-1] // 2}.get(leaf)
        if inner is None or not ff_cut(inner, tensor):
            return None, 1
        return {"weight": 0, "bias": 0, "lora_b": 1}[leaf], 2
    if module.endswith("." + FF_DOWN):
        inner = {"weight": shape[-1], "lora_a": shape[0]}.get(leaf)
        if inner is None or not ff_cut(inner, tensor):
            return None, 1
        return {"weight": 1, "lora_a": 0}[leaf], 1
    return None, 1


def param_placement(name: str, shape: Sequence[int], fsdp: int, tensor: int,
                    min_weight_size: int = MIN_WEIGHT_SIZE,
                    heads: Optional[int] = None) -> Placement:
    """The placement of the UNet parameter `name` (the reference's key, e.g.
    `input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight`) of torch
    `shape` on an fsdp x tensor mesh. `heads` is the head count of the
    attention layer that owns it (an attention projection is cut only
    where it divides by `tensor`)."""
    shape = tuple(int(d) for d in shape)
    if any(s in name for s in FSDP_EXCLUDE_SUBSTRINGS):
        return REPLICATED
    tensor_dim, blocks = _tensor_cut(name, shape, tensor, heads)
    return Placement(_fsdp_dim(name, shape, fsdp, min_weight_size, tensor_dim), tensor_dim,
                     blocks if tensor_dim is not None else 1)


def attention_heads(module: torch.nn.Module) -> Dict[str, int]:
    """{name: head count} of the attention layers (to_q ... to_out) of `module`."""
    return {name: m.heads for name, m in module.named_modules()
            if hasattr(m, "to_q") and hasattr(m, "heads")}


def _owner(name: str, heads: Dict[str, int]) -> Optional[int]:
    module = _split(name)[0]
    for proj in COLUMN_PROJECTIONS + (ROW_PROJECTION,):
        if module.endswith("." + proj):
            return heads.get(module[:-len(proj) - 1])
    return None


def unet_placements(unet: torch.nn.Module, fsdp: int, tensor: int,
                    min_weight_size: Optional[int] = None) -> Dict[str, Placement]:
    """param_placement of every parameter of `unet` (built whole, before any
    cut), by its name under the UNet. `min_weight_size` defaults to
    MIN_WEIGHT_SIZE as it stands at the call."""
    mws = MIN_WEIGHT_SIZE if min_weight_size is None else min_weight_size
    heads = attention_heads(unet)
    return {name: param_placement(name, p.shape, fsdp, tensor, mws, _owner(name, heads))
            for name, p in unet.named_parameters()}


def uncut_layers(unet: torch.nn.Module, tensor: int) -> List[str]:
    """The attention layers whose heads, and the feed-forwards whose inner
    size, do not split over `tensor` ranks: they stay replicated."""
    if tensor <= 1:
        return []
    out = [f"{name} ({h} heads)" for name, h in attention_heads(unet).items() if h % tensor]
    for name, m in unet.named_modules():
        if hasattr(m, "net") and hasattr(m.net[0], "proj"):
            inner = m.net[2].in_features
            if not ff_cut(inner, tensor):
                out.append(f"{name} (inner {inner})")
    return out


def placement_summary(unet: torch.nn.Module, placements: Dict[str, Placement], fsdp: int,
                      tensor: int, trainable: Optional[Sequence[str]] = None) -> Dict:
    """Parameters, tensors and bf16 bytes (2 an element, whole weights)
    sharded over fsdp, cut over tensor (either or both) and replicated; the
    layers left uncut; and the parameter state a card holds: 12 bytes an
    element of its share of each trainable parameter (fp32 master, Adam's
    two moments), plus the bf16 module weight (2 bytes an element) of each
    parameter FSDP does not hold in fp32. `trainable` names the trainable
    parameters (all by default)."""
    named = dict(unet.named_parameters())
    trainable = set(named if trainable is None else trainable)
    out = {k: {"params": 0, "tensors": 0, "bf16_bytes": 0}
           for k in ("fsdp", "tensor", "both", "replicated")}
    per_card = 0
    for name, p in named.items():
        pl = placements[name]
        kind = ("both" if pl.fsdp_dim is not None and pl.tensor_dim is not None else
                "fsdp" if pl.fsdp_dim is not None else
                "tensor" if pl.tensor_dim is not None else "replicated")
        out[kind]["params"] += p.numel()
        out[kind]["tensors"] += 1
        out[kind]["bf16_bytes"] += 2 * p.numel()
        share = p.numel() // (fsdp if pl.fsdp_dim is not None else 1) \
            // (tensor if pl.tensor_dim is not None else 1)
        if pl.fsdp_dim is not None:
            per_card += 4 * share + (8 * share if name in trainable else 0)
        else:
            per_card += 2 * share + (12 * share if name in trainable else 0)
    return {"mesh": {"fsdp": fsdp, "tensor": tensor}, **out,
            "uncut_layers": uncut_layers(unet, tensor), "state_bytes_per_card": per_card}


def shard_blocks(t: torch.Tensor, dim: int, blocks: int, index: int, parts: int) -> torch.Tensor:
    """Share `index` of `parts` of `t` along `dim`, each of its `blocks`
    equal blocks cut alike ([b0_index | b1_index | ...])."""
    return torch.cat([b.chunk(parts, dim)[index] for b in t.chunk(blocks, dim)], dim)


def join_blocks(shares: Sequence[torch.Tensor], dim: int, blocks: int) -> torch.Tensor:
    """The inverse of shard_blocks over all its shares, in order."""
    split = [s.chunk(blocks, dim) for s in shares]
    return torch.cat([torch.cat([s[b] for s in split], dim) for b in range(blocks)], dim)


class Mesh:
    """The ("data", "fsdp", "tensor") mesh over the process group: this
    process's coordinates, a torch DeviceMesh (what FSDP2 shards over) and
    the groups of the collectives: `fsdp_group` and `tensor_group` (the
    processes that differ only on that axis) and `batch_group` (those of
    this process's tensor coordinate: the data x fsdp processes whose
    gradients of a replicated parameter are averaged)."""

    def __init__(self, data: int, fsdp: int, tensor: int, device_type: str):
        self.shape = {"data": data, "fsdp": fsdp, "tensor": tensor}
        self.data, self.fsdp, self.tensor = data, fsdp, tensor
        self.rank = dist.get_rank()
        d, f, t = np.unravel_index(self.rank, (data, fsdp, tensor))
        self.coords = {"data": int(d), "fsdp": int(f), "tensor": int(t)}
        from torch.distributed.device_mesh import init_device_mesh

        self.device_mesh = init_device_mesh(device_type, (data, fsdp, tensor),
                                            mesh_dim_names=AXES)
        self.fsdp_group = self.device_mesh.get_group("fsdp")
        self.tensor_group = self.device_mesh.get_group("tensor")
        self.batch_group = None  # the whole group when tensor == 1
        if tensor > 1:
            world = data * fsdp * tensor
            for coord in range(tensor):  # every process creates every group
                group = dist.new_group([r for r in range(world) if r % tensor == coord])
                if coord == self.coords["tensor"]:
                    self.batch_group = group

        self._frame_groups = None

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def frame_groups(self) -> Dict[Tuple[int, int], object]:
        """{(F, video block): process group} of this process's frame groups:
        for every split of the data x fsdp batch ranks into V video blocks of
        F > 1 frame ranks (V a divisor of data x fsdp), the group of the F
        batch ranks of each video block at this process's tensor
        coordinate, in frame-block order. Made on the first call; every
        process creates every group, in the same order, so every process
        must make that call."""
        if self._frame_groups is None:
            self._frame_groups = {}
            blocks = self.batch_count
            for f in range(2, blocks + 1):
                if blocks % f:
                    continue
                for video_block in range(blocks // f):
                    for coord in range(self.tensor):
                        ranks = [(video_block * f + i) * self.tensor + coord for i in range(f)]
                        group = dist.new_group(ranks)
                        if self.rank in ranks:
                            self._frame_groups[(f, video_block)] = group
        return self._frame_groups

    @property
    def batch_count(self) -> int:
        """Row blocks of the global batch: data x fsdp."""
        return self.data * self.fsdp

    @property
    def batch_coordinate(self) -> int:
        """This process's row block of the global batch (make_batch_shardings:
        the batch's leading axis over ("data", "fsdp")); the processes of
        one tensor group share it."""
        return self.rank // self.tensor

    def fsdp_device_mesh(self):
        """The DeviceMesh FSDP2 shards over: fsdp, with data as HSDP's
        replicate dimension when data > 1."""
        if self.data > 1:
            return self.device_mesh["data", "fsdp"]
        return self.device_mesh["fsdp"]

    def full_shape(self, shape: Sequence[int], pl: Placement) -> Tuple[int, ...]:
        """The whole parameter's shape from a share's."""
        shape = list(shape)
        if pl.fsdp_dim is not None:
            shape[pl.fsdp_dim] *= self.fsdp
        if pl.tensor_dim is not None:
            shape[pl.tensor_dim] *= self.tensor
        return tuple(shape)

    def gather(self, t: torch.Tensor, pl: Placement) -> torch.Tensor:
        """The whole tensor from every process's share `t` (a collective of
        the fsdp and tensor groups, in that order, where `pl` has the axis)."""
        t = t.contiguous()
        if pl.fsdp_dim is not None and self.fsdp > 1:
            parts = [torch.empty_like(t) for _ in range(self.fsdp)]
            dist.all_gather(parts, t, group=self.fsdp_group)
            t = torch.cat(parts, pl.fsdp_dim)
        if pl.tensor_dim is not None and self.tensor > 1:
            parts = [torch.empty_like(t) for _ in range(self.tensor)]
            dist.all_gather(parts, t, group=self.tensor_group)
            t = join_blocks(parts, pl.tensor_dim, pl.tensor_blocks)
        return t

    def local(self, t: torch.Tensor, pl: Placement) -> torch.Tensor:
        """This process's share of the whole tensor `t`."""
        if pl.tensor_dim is not None and self.tensor > 1:
            t = shard_blocks(t, pl.tensor_dim, pl.tensor_blocks, self.coords["tensor"],
                             self.tensor)
        if pl.fsdp_dim is not None and self.fsdp > 1:
            t = t.chunk(self.fsdp, pl.fsdp_dim)[self.coords["fsdp"]]
        return t


def create_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1,
                device_type: str = "cuda") -> Mesh:
    """The mesh over the current process group; data=-1 takes the processes
    that fsdp x tensor leaves. Raises unless data x fsdp x tensor is the
    process count."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        if n % (fsdp * tensor):
            raise ValueError(f"{n} processes do not divide by fsdp={fsdp} x tensor={tensor}")
        data = n // (fsdp * tensor)
    if data * fsdp * tensor != n or min(data, fsdp, tensor) < 1:
        raise ValueError(f"mesh {data}x{fsdp}x{tensor} != {n} processes")
    if not dist.is_initialized():
        raise ValueError("a mesh needs a process group (--coordinator)")
    return Mesh(data, fsdp, tensor, device_type)

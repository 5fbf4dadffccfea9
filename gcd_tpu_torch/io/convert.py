"""Weight bridge: flax parameter tree -> torch state dict (the main model;
LPIPS and InceptionV3 by their own functions at the end).

The port's own copy of the JAX package's numpy path translation
(gcd_tpu/io/convert.py: flax_path_to_torch_key, torch_layout_from_flax,
gcd_clip_rename); the port imports nothing of that package. Linear
(in, out) -> (out, in), conv HWIO -> OIHW, DHWIO -> OIDHW, the CLIP tower's
combined in_proj (C, 3C) -> (3C, C). The port's modules use the reference's
parameter names, so the result loads with `load_state_dict(..., strict=True)`.
JAX's `params["lora"]` tree ({path: {"lora_a", "lora_b"}}) carries across
as it is, prefixed like the UNet: its leaves are direct parameters, which
land on the port's adapters (`<module>.lora_a` / `.lora_b`,
models/lora.py) in JAX's layout.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Module-name segments that are flax-side wrappers with no torch counterpart
# ("spatial" holds a VideoResBlock's base ResBlock params, which in torch live
# at the block root since VideoResBlock subclasses ResBlock).
_SKIP_SEGMENTS = {"spatial"}

# Exact-name segment rewrites (flax name -> torch name), applied before the
# generic numeric-suffix split.
_SEGMENT_RENAMES = {
    "mid_block_1": "mid.block_1",
    "mid_block_2": "mid.block_2",
    "mid_attn_1": "mid.attn_1",
    "net_0_proj": "net.0.proj",
    "net_0": "net.0",
    "net_2": "net.2",
    "to_out_0": "to_out.0",
    "mlp_c_fc": "mlp.c_fc",
    "mlp_c_proj": "mlp.c_proj",
    # CLIP block norms keep their literal names (the numeric-suffix splitter
    # would emit ln.1 / ln.2).
    "ln_1": "ln_1",
    "ln_2": "ln_2",
    "conv2d": "",  # AE3DConvOut's 2D conv lives at the AE3DConv root in torch
}

# Names whose trailing _<d> indices become torch dots: input_blocks_4_1 ->
# input_blocks.4.1.
_NUM_SUFFIX = re.compile(r"^(.*?)((?:_\d+)+)$")

# VAE down/up paths: down_0_block_1 -> down.0.block.1 etc.
_VAE_PATH = re.compile(r"^(down|up)_(\d+)_(block|attn|downsample|upsample)(?:_(\d+))?$")


def _translate_segment(seg: str) -> str:
    if seg in _SEGMENT_RENAMES:
        return _SEGMENT_RENAMES[seg]
    m = _VAE_PATH.match(seg)
    if m:
        parts = [m.group(1), m.group(2), m.group(3)]
        if m.group(4) is not None:
            parts.append(m.group(4))
        return ".".join(parts)
    m = _NUM_SUFFIX.match(seg)
    if m and m.group(1) and not m.group(1).endswith("_"):
        nums = m.group(2).strip("_").split("_")
        return ".".join([m.group(1)] + nums)
    return seg


def flax_path_to_torch_key(path: Sequence[str]) -> Optional[Tuple[str, str]]:
    """A flax param path (segment names ending in the leaf name) ->
    (torch key, kind), kind in {linear_or_conv, norm, plain, direct, mha_w,
    mha_b}."""
    segs = [s for s in path[:-1] if s not in _SKIP_SEGMENTS]
    leaf = path[-1]
    # GroupNorm32 / VAEGroupNorm / LayerNormFp32 name their inner flax norm
    # "norm", directly before the scale/bias leaf; it has no torch level.
    if len(segs) >= 2 and segs[-1] == "norm" and leaf in ("scale", "bias"):
        segs = segs[:-1]
    # MultiheadAttention's combined projection: attn/in_proj -> attn.in_proj_weight
    if segs and segs[-1] == "in_proj":
        base = ".".join(_translate_segment(s) for s in segs[:-1] if _translate_segment(s))
        if leaf == "kernel":
            return f"{base}.in_proj_weight", "mha_w"
        return f"{base}.in_proj_bias", "mha_b"
    base = ".".join(p for p in (_translate_segment(s) for s in segs) if p)
    if leaf == "kernel":
        return f"{base}.weight", "linear_or_conv"
    if leaf == "scale":
        return f"{base}.weight", "norm"
    if leaf == "bias":
        return f"{base}.bias", "plain"
    # Direct parameters (class_embedding, positional_embedding, proj, mix_factor)
    if base:
        return f"{base}.{leaf}", "direct"
    return leaf, "direct"


def torch_layout_from_flax(arr: np.ndarray, kind: str) -> np.ndarray:
    """A flax-layout array -> the torch layout the reference checkpoints store."""
    arr = np.asarray(arr)
    if kind == "linear_or_conv":
        if arr.ndim == 2:
            return arr.T
        if arr.ndim == 4:  # HWIO -> OIHW
            return arr.transpose(3, 2, 0, 1)
        if arr.ndim == 5:  # DHWIO -> OIDHW
            return arr.transpose(4, 3, 0, 1, 2)
        return arr
    if kind == "mha_w":
        return arr.T
    return arr


def gcd_clip_rename(key: str) -> str:
    """The GCD/SVD checkpoints' OpenCLIP image tower keys
    (conditioner.embedders.0.open_clip.model.visual.*): the reference wraps
    the tower in `.model.` (the open_clip CLIP object) and nests resblocks
    under `transformer.`; neither is a flax module level."""
    key = key.replace("open_clip.visual.", "open_clip.model.visual.")
    return key.replace(".visual.resblocks.", ".visual.transformer.resblocks.")


def _iter_tree_paths(tree: Dict, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(_iter_tree_paths(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def state_dict_from_flax(params: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """`params`: nested dicts of numpy arrays (a flax `params` tree).
    Returns {gcd_clip_rename(prefix + torch key): tensor}."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _iter_tree_paths(params):
        key, kind = flax_path_to_torch_key(path)
        arr = np.ascontiguousarray(torch_layout_from_flax(np.asarray(leaf), kind))
        out[gcd_clip_rename(prefix + key)] = torch.from_numpy(arr)
    return out


def lpips_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX's LPIPS `params` tree (gcd_tpu/models/lpips.py: net/features_{i}
    kernel and bias, lin{i}_weight (C,)), as numpy, -> the port's LPIPS
    state dict (models/lpips.py: net.slice{k}.{i}.weight OIHW / bias,
    lin{i}.model.1.weight (1, C, 1, 1))."""
    from gcd_tpu_torch.models.lpips import VGG_CONV_IDX

    out: Dict[str, torch.Tensor] = {}
    for stage, conv_ids in enumerate(VGG_CONV_IDX):
        for ci in conv_ids:
            conv = params["net"][f"features_{ci}"]
            out[f"net.slice{stage + 1}.{ci}.weight"] = torch.from_numpy(
                np.array(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)))
            out[f"net.slice{stage + 1}.{ci}.bias"] = torch.from_numpy(np.array(conv["bias"]))
    for i in range(len(VGG_CONV_IDX)):
        w = np.array(params[f"lin{i}_weight"])
        out[f"lin{i}.model.1.weight"] = torch.from_numpy(w.reshape(1, -1, 1, 1))
    return out


def inception_state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX's InceptionV3 variables ({"params", "batch_stats"}, as numpy) ->
    the port's pytorch-fid-named state dict: conv kernels HWIO -> OIHW, the
    BatchNorm scale / bias and its batch_stats mean / var as
    bn.weight / bias / running_mean / running_var. The classifier `fc`,
    which JAX does not build, is not in it."""
    names = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
    out: Dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _iter_tree_paths(variables.get(col, {})):
            arr = np.asarray(leaf)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            out[".".join(path[:-1] + (names[path[-1]],))] = torch.from_numpy(np.array(arr))
    return out

"""Weight bridge: flax parameter tree -> torch state dict (the main model;
LPIPS, InceptionV3, the first stage with a VQ regularizer, the quantizers,
the discriminator, and the embedders whose reference names are not the
flax paths' (the text towers, GaussianEncoder, LowScaleEncoder,
ClassEmbedder) by their own functions at the end).

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


def quantizer_state_dict_from_flax(variables: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX quantizer's variables (gcd_tpu/models/vq.py: {"params"[,
    "ema"]}, as numpy) -> the port's keys (models/vq.py): the codebook
    leaves `embedding` / `embed` as `embedding.weight` / `embed.weight`,
    the EMA collection's weight / cluster_size / embed_avg under
    `embedding.`, convs and linears as state_dict_from_flax."""
    out: Dict[str, torch.Tensor] = {}
    for key, t in state_dict_from_flax(variables.get("params", {}), prefix).items():
        out[key + ".weight" if key.rsplit(".", 1)[-1] in ("embedding", "embed") else key] = t
    for name, leaf in variables.get("ema", {}).items():
        out[f"{prefix}embedding.{name}"] = torch.from_numpy(np.array(leaf))
    return out


def first_stage_state_dict_from_flax(params: Dict, prefix: str = "first_stage_model."
                                     ) -> Dict[str, torch.Tensor]:
    """A JAX first stage's params (encoder, decoder[, quant_conv,
    post_quant_conv][, regularization: a VQ regularizer's variables]) ->
    the port's keys under `prefix`."""
    params = dict(params)
    reg = params.pop("regularization", None)
    out = state_dict_from_flax(params, prefix)
    if reg is not None:
        out.update(quantizer_state_dict_from_flax(reg, prefix + "regularization."))
    return out


def discriminator_state_dict_from_flax(variables: Dict, prefix: str = ""
                                       ) -> Dict[str, torch.Tensor]:
    """A JAX NLayerDiscriminator's variables ({"params"[, "batch_stats"]},
    as numpy) -> the port's `main.{i}.*` keys (models/discriminator.py):
    conv kernels HWIO -> OIHW; BatchNorm scale / bias -> weight / bias and
    its batch_stats mean / var -> running_mean / running_var, with
    num_batches_tracked 0 (flax keeps no count); ActNorm's loc / scale as
    they are."""
    out: Dict[str, torch.Tensor] = {}
    for name, leaves in variables["params"].items():
        base = prefix + _translate_segment(name)
        for leaf, arr in leaves.items():
            arr = np.asarray(arr)
            if leaf == "kernel":
                arr, leaf = arr.transpose(3, 2, 0, 1), "weight"
            elif leaf == "scale" and "loc" not in leaves:
                leaf = "weight"
            out[f"{base}.{leaf}"] = torch.from_numpy(np.array(arr))
    for name, stats in variables.get("batch_stats", {}).items():
        base = prefix + _translate_segment(name)
        out[f"{base}.running_mean"] = torch.from_numpy(np.array(stats["mean"]))
        out[f"{base}.running_var"] = torch.from_numpy(np.array(stats["var"]))
        out[f"{base}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return out


def discriminator_loss_state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """A JAX GeneralLPIPSWithDiscriminator's variables (the discriminator's
    params and batch_stats, and `logvar`) -> the port loss's keys."""
    out = discriminator_state_dict_from_flax(variables, "discriminator.")
    out["logvar"] = torch.tensor(float(np.asarray(variables["logvar"])))
    return out


# --- The text towers' checkpoint names (the port's copies of
# gcd_tpu/io/convert.py t5_rename, hf_clip_text_to_openclip_sd and
# openclip_text_rename). --------------------------------------------------

_T5_KEY = re.compile(
    r"^block_(\d+)_(attn\.(?:q|k|v|o)|ln\.(\d+)|wi(?:\.\d+)?|wo)\.weight$"
)


def t5_rename(key: str) -> str:
    """A T5Encoder key from the flax path (block_N_attn.q.weight,
    block_N_ln.0.weight, block_N_wi.0.weight, shared, ...) -> transformers'
    T5EncoderModel key (encoder.block.N.layer.0.SelfAttention.q.weight,
    encoder.block.N.layer.0.layer_norm.weight,
    encoder.block.N.layer.1.DenseReluDense.wi_0.weight, shared.weight, ...)."""
    if key == "shared":
        return "shared.weight"
    if key == "relative_attention_bias":
        return ("encoder.block.0.layer.0.SelfAttention."
                "relative_attention_bias.weight")
    if key == "final_layer_norm.weight":
        return "encoder.final_layer_norm.weight"
    m = _T5_KEY.match(key)
    if m:
        n, mid = m.group(1), m.group(2)
        if mid.startswith("attn."):
            return f"encoder.block.{n}.layer.0.SelfAttention.{mid[5:]}.weight"
        if mid.startswith("ln."):
            layer = mid.split(".")[1]
            return f"encoder.block.{n}.layer.{layer}.layer_norm.weight"
        ff = mid.replace("wi.0", "wi_0").replace("wi.1", "wi_1")
        return f"encoder.block.{n}.layer.1.DenseReluDense.{ff}.weight"
    return key


def hf_clip_text_to_openclip_sd(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Re-key a transformers CLIPTextModel state dict (numpy arrays or
    tensors) into open_clip text-tower names (token_embedding.weight,
    transformer.resblocks.N.attn.in_proj_*, ...), merging the separate
    q / k / v projections into the combined in_proj."""
    out: Dict[str, Any] = {}
    pre = "text_model."
    qkv: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        if not k.startswith(pre):
            continue
        k = k[len(pre):]
        if k == "embeddings.token_embedding.weight":
            out["token_embedding.weight"] = v
        elif k == "embeddings.position_embedding.weight":
            out["positional_embedding"] = v
        elif k == "final_layer_norm.weight":
            out["ln_final.weight"] = v
        elif k == "final_layer_norm.bias":
            out["ln_final.bias"] = v
        elif k.startswith("encoder.layers."):
            rest = k[len("encoder.layers."):]
            n, sub = rest.split(".", 1)
            base = f"transformer.resblocks.{n}"
            m = re.match(r"self_attn\.([qkv])_proj\.(weight|bias)$", sub)
            if m:
                qkv.setdefault(f"{base}|{m.group(2)}", {})[m.group(1)] = v
            elif sub.startswith("self_attn.out_proj."):
                out[f"{base}.attn.out_proj.{sub.rsplit('.', 1)[1]}"] = v
            elif sub.startswith("layer_norm1."):
                out[f"{base}.ln_1.{sub.rsplit('.', 1)[1]}"] = v
            elif sub.startswith("layer_norm2."):
                out[f"{base}.ln_2.{sub.rsplit('.', 1)[1]}"] = v
            elif sub.startswith("mlp.fc1."):
                out[f"{base}.mlp.c_fc.{sub.rsplit('.', 1)[1]}"] = v
            elif sub.startswith("mlp.fc2."):
                out[f"{base}.mlp.c_proj.{sub.rsplit('.', 1)[1]}"] = v
    for key, parts in qkv.items():
        base, leaf = key.split("|")
        qkv_parts = [parts["q"], parts["k"], parts["v"]]
        out[f"{base}.attn.in_proj_{leaf}"] = (torch.cat(qkv_parts) if torch.is_tensor(
            qkv_parts[0]) else np.concatenate(qkv_parts, axis=0))
    # CLIPTextModelWithProjection stores (out, width); open_clip stores the
    # transposed parameter directly.
    if "text_projection.weight" in sd:
        out["text_projection"] = sd["text_projection.weight"].T
    return out


def openclip_text_rename(key: str) -> str:
    """A CLIPTextTower key from the flax path -> open_clip's text key."""
    if key.startswith("resblocks."):
        return "transformer." + key
    if key == "token_embedding":
        return "token_embedding.weight"
    return key


def _strip(sd: Dict[str, torch.Tensor], head: str) -> Dict[str, torch.Tensor]:
    return {k[len(head):]: v for k, v in sd.items() if k.startswith(head)}


def embedder_state_dict_from_flax(embedder, params: Dict, prefix: str = ""
                                  ) -> Dict[str, torch.Tensor]:
    """A JAX embedder's params (gcd_tpu/models/embedders.py, as numpy) ->
    the port embedder's keys under `prefix`, which are the reference's:
    the T5 tower as transformers' T5EncoderModel under `transformer.`
    (embed_tokens tied to shared), FrozenCLIPEmbedder's open_clip names
    under `transformer.` (to which it re-keys a CLIPTextModel checkpoint),
    the OpenCLIP towers open_clip's under `model.`
    (with the logit_scale JAX does not keep), GaussianEncoder's encoder at
    the root, LowScaleEncoder's KL autoencoder under `model.` (with its
    schedule buffers, which JAX does not keep), ClassEmbedder's table as
    embedding.weight; any other embedder as state_dict_from_flax."""
    name = type(embedder).__name__
    generic = state_dict_from_flax(params)
    if name in ("FrozenT5Embedder", "FrozenByT5Embedder"):
        sd = {"transformer." + t5_rename(k): v
              for k, v in _strip(generic, "transformer.").items()}
        sd["transformer.encoder.embed_tokens.weight"] = sd["transformer.shared.weight"]
    elif name == "FrozenCLIPEmbedder":
        sd = {"transformer." + openclip_text_rename(k): v
              for k, v in _strip(generic, "transformer.").items()}
    elif name in ("FrozenOpenCLIPEmbedder", "FrozenOpenCLIPEmbedder2"):
        sd = {"model." + openclip_text_rename(k): v
              for k, v in _strip(generic, "model.").items()}
        sd["model.logit_scale"] = embedder.model.logit_scale.detach().float().cpu().clone()
    elif name == "GaussianEncoder":
        sd = _strip(generic, "encoder.")
    elif name == "LowScaleEncoder":
        sd = {"model." + k: v for k, v in generic.items()}
        sd.update({k: b.detach().cpu().clone() for k, b in embedder.named_buffers()})
    elif name == "ClassEmbedder":
        sd = {"embedding.weight": generic["embedding.embedding"]}
    else:
        sd = generic
    return {prefix + k: v for k, v in sd.items()}


def conditioner_state_dict_from_flax(conditioner, params: Dict, prefix: str = ""
                                     ) -> Dict[str, torch.Tensor]:
    """A JAX GeneralConditioner's params ({"embedders_i": ...}) -> the port
    conditioner's keys under `prefix`, each embedder by
    embedder_state_dict_from_flax."""
    out: Dict[str, torch.Tensor] = {}
    for i, emb in enumerate(conditioner.embedders):
        out.update(embedder_state_dict_from_flax(emb, params.get(f"embedders_{i}", {}),
                                                 f"{prefix}embedders.{i}."))
    return out

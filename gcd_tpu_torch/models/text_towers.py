"""Text encoder towers: the CLIP text transformer and the T5 encoder (port of
gcd_tpu/models/text_towers.py).

`CLIPTextTower` keeps open_clip's text names (token_embedding,
positional_embedding, transformer.resblocks.N, ln_final, text_projection;
FrozenCLIPEmbedder re-keys transformers' CLIPTextModel checkpoints to
these as they load). `T5Encoder` keeps transformers' T5EncoderModel names
(shared, encoder.embed_tokens tied to it, encoder.block.N.layer.{0,1},
encoder.final_layer_norm). So the reference checkpoints' keys load with
strict=True.

The JAX package runs these towers through its XLA attention (causal, or
with T5's position bias): no kernel takes them, and here they are
ops/basic.py's dot_product_attention, products by torch.matmul. The
rounding points are the JAX package's: LayerNorm in fp32 cast back, the
fp32 T5 RMSNorm product (a bf16 T5 encoder emits fp32, as in JAX), fp32
logits and softmax, weights in the activations' dtype for PV.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gcd_tpu_torch.models.clip import CLIPBlock
from gcd_tpu_torch.models.layers import LayerNormFp32
from gcd_tpu_torch.ops.basic import dot_product_attention


def _tower_outputs(hidden: List[torch.Tensor], ln_final: nn.Module, tokens: torch.Tensor,
                   projection: Optional[torch.Tensor]) -> Dict[str, object]:
    """The outputs of gcd_tpu's CLIPTextTower from its per-layer states:
    "last" / "penultimate" (before ln_final), "hidden" (every state,
    embeddings first), "normed" / "normed_penultimate" (ln_final in fp32,
    cast back), "pooled" (the eot token of "normed", the row's largest id,
    times `projection` when given)."""
    normed = ln_final(hidden[-1])
    eot = tokens.argmax(dim=-1)
    pooled = normed[torch.arange(tokens.shape[0], device=tokens.device), eot]
    if projection is not None:
        pooled = pooled @ projection.to(pooled.dtype)
    return {"last": hidden[-1], "penultimate": hidden[-2], "hidden": hidden,
            "normed": normed, "normed_penultimate": ln_final(hidden[-2]), "pooled": pooled}


class _Resblocks(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, quick_gelu: bool):
        super().__init__()
        self.resblocks = nn.ModuleList(CLIPBlock(width, heads, causal=True,
                                                 quick_gelu=quick_gelu)
                                       for _ in range(layers))


class CLIPTextTower(nn.Module):
    """The CLIP text transformer, open_clip's names: tokens (B, S) -> the
    _tower_outputs dict. Causal pre-LN blocks over token + positional
    embeddings; `output_dim` adds the pooled output's text_projection."""

    def __init__(self, vocab_size: int = 49408, width: int = 1024, layers: int = 24,
                 heads: int = 16, context_length: int = 77,
                 output_dim: Optional[int] = 1024, quick_gelu: bool = False):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.transformer = _Resblocks(width, layers, heads, quick_gelu)
        self.ln_final = LayerNormFp32(width)
        if output_dim is not None:
            self.text_projection = nn.Parameter(torch.zeros(width, output_dim))

    def forward(self, tokens: torch.Tensor) -> Dict[str, object]:
        s = tokens.shape[1]
        h = self.token_embedding(tokens) + self.positional_embedding[:s]
        hidden = [h]
        for block in self.transformer.resblocks:
            hidden.append(block(hidden[-1]))
        return _tower_outputs(hidden, self.ln_final, tokens,
                              getattr(self, "text_projection", None))


def t5_relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                                max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 relative-position buckets, int32, with the JAX
    package's float32 arithmetic (its large-distance log in float32)."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    n_large = n.clamp(min=max_exact)
    log_ratio = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    val_if_large = max_exact + (
        torch.log(n_large.to(torch.float32) / max_exact) / log_ratio
        * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


class T5RMSNorm(nn.Module):
    """weight * (x / rms(x)) with the normalised x in x's dtype and the
    product in fp32 (the JAX package's promotion; transformers casts back)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight.float() * normed.to(x.dtype).float()


class T5SelfAttention(nn.Module):
    """Unscaled multi-head attention plus the position bias (B or 1, H, S,
    S) in fp32; inputs of any dtype enter in the weights' dtype."""

    def __init__(self, d_model: int, heads: int, d_kv: int, has_bias: bool,
                 num_buckets: int = 32):
        super().__init__()
        inner = heads * d_kv
        self.heads, self.d_kv = heads, d_kv
        self.q, self.k, self.v = (nn.Linear(d_model, inner, bias=False) for _ in range(3))
        self.o = nn.Linear(inner, d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        x = x.to(self.q.weight.dtype)
        b, s, _ = x.shape
        q, k, v = (p(x).reshape(b, s, self.heads, self.d_kv).transpose(1, 2)
                   for p in (self.q, self.k, self.v))
        out = dot_product_attention(q, k, v, scale=1.0, bias=position_bias)
        return self.o(out.transpose(1, 2).reshape(b, s, -1))


class T5DenseFF(nn.Module):
    """gelu_tanh(wi_0 x) * wi_1 x (gated) or relu(wi x), then wo."""

    def __init__(self, d_model: int, d_ff: int, gated: bool):
        super().__init__()
        if gated:
            self.wi_0 = nn.Linear(d_model, d_ff, bias=False)
            self.wi_1 = nn.Linear(d_model, d_ff, bias=False)
        else:
            self.wi = nn.Linear(d_model, d_ff, bias=False)
        self.wo = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.wo.weight.dtype)
        if hasattr(self, "wi"):
            return self.wo(F.relu(self.wi(x)))
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class _T5LayerAttention(nn.Module):
    def __init__(self, d_model: int, heads: int, d_kv: int, has_bias: bool, num_buckets: int):
        super().__init__()
        self.SelfAttention = T5SelfAttention(d_model, heads, d_kv, has_bias, num_buckets)
        self.layer_norm = T5RMSNorm(d_model)


class _T5LayerFF(nn.Module):
    def __init__(self, d_model: int, d_ff: int, gated: bool):
        super().__init__()
        self.DenseReluDense = T5DenseFF(d_model, d_ff, gated)
        self.layer_norm = T5RMSNorm(d_model)


class _T5Block(nn.Module):
    def __init__(self, d_model, d_ff, heads, d_kv, gated, has_bias, num_buckets):
        super().__init__()
        self.layer = nn.ModuleList([_T5LayerAttention(d_model, heads, d_kv, has_bias,
                                                      num_buckets),
                                    _T5LayerFF(d_model, d_ff, gated)])

    def forward(self, h: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        attn, ff = self.layer
        h = h + attn.SelfAttention(attn.layer_norm(h), position_bias)
        return h + ff.DenseReluDense(ff.layer_norm(h))


class _T5Stack(nn.Module):
    def __init__(self, shared: nn.Embedding, d_model, d_ff, num_layers, heads, d_kv, gated,
                 num_buckets):
        super().__init__()
        self.embed_tokens = shared  # tied, as in T5EncoderModel
        self.block = nn.ModuleList(
            _T5Block(d_model, d_ff, heads, d_kv, gated, i == 0, num_buckets)
            for i in range(num_layers))
        self.final_layer_norm = T5RMSNorm(d_model)


class T5Encoder(nn.Module):
    """T5 / ByT5 encoder (v1.1: RMSNorm, gated tanh-GELU FF or ReLU FF,
    one relative-position bias owned by block 0): tokens (B, S) -> final
    RMSNorm'd states (B, S, d_model), fp32."""

    def __init__(self, vocab_size: int = 32128, d_model: int = 4096, d_kv: int = 64,
                 d_ff: int = 10240, num_layers: int = 24, num_heads: int = 64,
                 relative_attention_num_buckets: int = 32,
                 relative_attention_max_distance: int = 128, gated_ff: bool = True):
        super().__init__()
        self.num_buckets = relative_attention_num_buckets
        self.max_distance = relative_attention_max_distance
        self.shared = nn.Embedding(vocab_size, d_model)
        self.encoder = _T5Stack(self.shared, d_model, d_ff, num_layers, num_heads, d_kv,
                                gated_ff, relative_attention_num_buckets)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        s = tokens.shape[1]
        h = self.shared(tokens)
        pos = torch.arange(s, device=tokens.device)
        buckets = t5_relative_position_bucket(pos[None, :] - pos[:, None], self.num_buckets,
                                              self.max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
        position_bias = table(buckets.long()).permute(2, 0, 1)[None].float()
        for block in self.encoder.block:
            h = block(h, position_bias)
        return self.encoder.final_layer_norm(h)


def byt5_tokenize(texts: Sequence[str], max_length: int = 77) -> torch.Tensor:
    """ByT5 tokens (B, max_length) int32: utf-8 bytes + 3 (pad 0, eos 1,
    unk 2), eos-terminated, truncated to max_length - 1 bytes, padded."""
    out = np.zeros((len(texts), max_length), dtype=np.int32)
    for i, t in enumerate(texts):
        ids = [b + 3 for b in t.encode("utf-8")][: max_length - 1] + [1]
        out[i, : len(ids)] = ids
    return torch.from_numpy(out)

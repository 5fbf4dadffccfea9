"""Vector-quantization regularizers (port of gcd_tpu/models/vq.py): the
sgm quantizers VectorQuantizer, VectorQuantizerWithInputProjection,
GumbelQuantizer and EMAVectorQuantizer. No GCD config uses them; the
shipped first stages are KL autoencoders.

As in the JAX package the quantizers take channels-last latents (B, H, W, C)
or (B, S, C). Parameter names are the reference's (`embedding.weight`,
`embed.weight`, `proj`, `proj_in` / `quantizer` / `proj_out`, and the EMA
codebook's `embedding.{weight,cluster_size,embed_avg}`, here buffers that
update in place in training mode, where the JAX module updates its "ema"
collection); io/convert.py `quantizer_state_dict_from_flax` carries a JAX
tree across. Random numbers come in from the caller: the `random`
unknown-index draws as `random_index` and the Gumbel noise as `gumbel`, or
from a `generator`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _load_remap(remap: Optional[str]) -> Optional[torch.Tensor]:
    """The used-codes table of a `remap` .npy file (gcd_tpu/models/vq.py:28-31)."""
    return None if remap is None else torch.from_numpy(np.load(remap))


def _remap_to_used(inds: torch.Tensor, used: torch.Tensor, re_embed: int, unknown_index,
                   random_index: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Raw codebook ids (B, ...) -> their positions in `used`; an id not in
    it gets `unknown_index`, or under "random" a draw in [0, re_embed):
    `random_index` (B, N) or one from `generator`
    (gcd_tpu/models/vq.py:34-49)."""
    ishape = inds.shape
    flat = inds.reshape(ishape[0], -1)
    match = flat[:, :, None] == used.to(flat.device)[None, None, :]
    new = match.int().argmax(dim=-1)
    unknown = ~match.any(dim=2)
    if unknown_index == "random":
        if random_index is None:
            if generator is None:
                raise ValueError("remap with unknown_index 'random' needs random_index or "
                                 "a generator")
            random_index = torch.randint(0, re_embed, new.shape, generator=generator,
                                         device=new.device)
        new = torch.where(unknown, random_index.to(new), new)
    else:
        new = torch.where(unknown, torch.full_like(new, int(unknown_index)), new)
    return new.reshape(ishape)


def _unmap_to_all(inds: torch.Tensor, used: torch.Tensor, re_embed: int) -> torch.Tensor:
    """Used-subset ids -> raw codebook ids (gcd_tpu/models/vq.py:52-58)."""
    ishape = inds.shape
    flat = inds.reshape(ishape[0], -1)
    if re_embed > used.shape[0]:
        flat = torch.where(flat >= used.shape[0], torch.zeros_like(flat), flat)
    return used.to(flat.device)[flat].reshape(ishape)


def _nearest(zf: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Index of each fp32 row's nearest fp32 codebook row (squared distance
    as |z|^2 + |e|^2 - 2 z e^T; ties to the first)."""
    d = (zf.pow(2).sum(1, keepdim=True) + codebook.pow(2).sum(1)[None, :]
         - 2.0 * zf @ codebook.t())
    return d.argmin(dim=1)


class VectorQuantizer(nn.Module):
    """VQ-VAE bottleneck (gcd_tpu/models/vq.py:61-141): nearest codebook
    entry, the loss beta * |sg(z_q) - z|^2 + |z_q - sg(z)|^2 (means) and
    straight-through gradients. forward(z (B, ..., e_dim)) ->
    (z_q, {loss_key, "min_encoding_indices"[, "perplexity", "cluster_usage"]})."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25, remap: Optional[str] = None,
                 unknown_index="random", sane_index_shape: bool = False,
                 log_perplexity: bool = False, loss_key: str = "loss/vq"):
        super().__init__()
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.remap, self.unknown_index = remap, unknown_index
        self.sane_index_shape, self.log_perplexity = sane_index_shape, log_perplexity
        self.loss_key = loss_key
        self.embedding = nn.Embedding(n_e, e_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / n_e, 1.0 / n_e)

    def forward(self, z: torch.Tensor, random_index: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        emb = self.embedding.weight
        idx = _nearest(z.reshape(-1, self.e_dim).float(), emb.float())
        z_q = emb[idx].reshape(z.shape).to(z.dtype)

        loss_dict: Dict[str, torch.Tensor] = {}
        if self.log_perplexity:
            probs = F.one_hot(idx, self.n_e).float().mean(dim=0)
            loss_dict["perplexity"] = torch.exp(-(probs * torch.log(probs + 1e-10)).sum())
            loss_dict["cluster_usage"] = (probs > 0).sum()
        loss_dict[self.loss_key] = (self.beta * ((z_q.detach() - z) ** 2).mean()
                                    + ((z_q - z.detach()) ** 2).mean())
        z_q = z + (z_q - z).detach()  # straight-through

        used = _load_remap(self.remap)
        if used is not None:
            idx = _remap_to_used(idx.reshape(z.shape[0], -1), used, used.shape[0],
                                 self.unknown_index, random_index, generator).reshape(-1, 1)
        if self.sane_index_shape:
            idx = idx.reshape(z.shape[:3] if z.dim() == 4 else (z.shape[0], -1))
        loss_dict["min_encoding_indices"] = idx
        return z_q, loss_dict

    def get_codebook_entry(self, indices: torch.Tensor,
                           shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        """Codebook rows of `indices`, reshaped to `shape` (B, H, W, C) when
        given (needed with a remap)."""
        used = _load_remap(self.remap)
        if used is not None:
            if shape is None:
                raise ValueError("get_codebook_entry with a remap needs shape")
            indices = _unmap_to_all(indices.reshape(shape[0], -1), used, self.n_e).reshape(-1)
        z_q = self.embedding.weight[indices]
        return z_q if shape is None else z_q.reshape(shape)


class VectorQuantizerWithInputProjection(nn.Module):
    """Linear proj_in, VectorQuantizer, optional Linear proj_out
    (gcd_tpu/models/vq.py:144-188). A (B, ..., C) input of more than three
    dimensions is quantized as (B, S, C) and laid back when there is a
    proj_out."""

    def __init__(self, input_dim: int, n_codes: int, codebook_dim: int, beta: float = 1.0,
                 output_dim: Optional[int] = None, **kwargs):
        super().__init__()
        self.output_dim = output_dim
        self.proj_in = nn.Linear(input_dim, codebook_dim)
        self.quantizer = VectorQuantizer(n_codes, codebook_dim, beta, **kwargs)
        if output_dim is not None:
            self.proj_out = nn.Linear(codebook_dim, output_dim)

    def forward(self, z: torch.Tensor, random_index: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        in_shape = z.shape
        if z.dim() > 3:
            z = z.reshape(in_shape[0], -1, in_shape[-1])
        z_q, loss_dict = self.quantizer(self.proj_in(z), random_index, generator)
        if self.output_dim is not None:
            z_q = self.proj_out(z_q)
            if len(in_shape) > 3:
                z_q = z_q.reshape(*in_shape[:-1], z_q.shape[-1])
        return z_q, loss_dict


class GumbelQuantizer(nn.Module):
    """Gumbel-softmax quantizer (gcd_tpu/models/vq.py:191-249), channels
    last: a 1x1 `proj` to n_embed logits, softmax((logits + g) / temp),
    hard one-hots with straight-through gradients (always outside training,
    `straight_through` in it), z_q = one-hots @ `embed`, and the KL term to
    the uniform prior. The Gumbel noise g is `gumbel` (the logits' shape),
    or drawn from `generator`, or zero (a deterministic evaluation); training
    needs one of the first two, as the JAX module needs a key."""

    def __init__(self, num_hiddens: int, embedding_dim: int, n_embed: int,
                 straight_through: bool = True, kl_weight: float = 5e-4,
                 temp_init: float = 1.0, remap: Optional[str] = None,
                 unknown_index="random", loss_key: str = "loss/vq"):
        super().__init__()
        # remap and unknown_index are accepted for config parity: the JAX
        # module reads neither.
        self.n_embed, self.straight_through = n_embed, straight_through
        self.kl_weight, self.temp_init, self.loss_key = kl_weight, temp_init, loss_key
        self.proj = nn.Conv2d(num_hiddens, n_embed, 1)
        self.embed = nn.Embedding(n_embed, embedding_dim)
        nn.init.normal_(self.embed.weight)

    def forward(self, z: torch.Tensor, gumbel: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, temp: Optional[float] = None,
                return_logits: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        hard = self.straight_through if self.training else True
        tau = self.temp_init if temp is None else temp
        logits = F.linear(z, self.proj.weight[:, :, 0, 0], self.proj.bias)  # (B, H, W, N)
        if gumbel is None and generator is not None:
            u = torch.rand(logits.shape, generator=generator, device=logits.device)
            gumbel = -torch.log(-torch.log(u))
        if gumbel is None:
            if self.training:
                raise ValueError("GumbelQuantizer in training needs gumbel noise or a generator")
            gumbel = torch.zeros_like(logits, dtype=torch.float32)
        y_soft = torch.softmax((logits.float() + gumbel) / tau, dim=-1)
        if hard:
            y_hard = F.one_hot(y_soft.argmax(dim=-1), self.n_embed).to(y_soft.dtype)
            soft_one_hot = y_hard + y_soft - y_soft.detach()
        else:
            soft_one_hot = y_soft
        z_q = soft_one_hot.to(z.dtype) @ self.embed.weight

        qy = torch.softmax(logits.float(), dim=-1)
        out = {self.loss_key: self.kl_weight * (qy * torch.log(qy * self.n_embed + 1e-10))
               .sum(dim=-1).mean(),
               "indices": soft_one_hot.argmax(dim=-1)}
        if return_logits:
            out["logits"] = logits
        return z_q, out


class EmbeddingEMA(nn.Module):
    """The EMA codebook's state, buffers under the reference's names."""

    def __init__(self, num_tokens: int, codebook_dim: int):
        super().__init__()
        weight = torch.randn(num_tokens, codebook_dim)
        self.register_buffer("weight", weight)
        self.register_buffer("cluster_size", torch.zeros(num_tokens))
        self.register_buffer("embed_avg", weight.clone())


class EMAVectorQuantizer(nn.Module):
    """VQ with an exponential-moving-average codebook
    (gcd_tpu/models/vq.py:252-298): nearest entry, the commitment loss
    beta * |sg(z_q) - z|^2, straight-through gradients; in training mode
    each call folds the batch's counts and sums into `cluster_size` and
    `embed_avg` with `decay` and sets the codebook to their Laplace-smoothed
    ratio, in place."""

    def __init__(self, n_embed: int, embedding_dim: int, beta: float, decay: float = 0.99,
                 eps: float = 1e-5, remap: Optional[str] = None, unknown_index="random",
                 loss_key: str = "loss/vq"):
        super().__init__()
        # remap and unknown_index are accepted for config parity: the JAX
        # module reads neither.
        self.n_embed, self.embedding_dim, self.beta = n_embed, embedding_dim, beta
        self.decay, self.eps, self.loss_key = decay, eps, loss_key
        self.embedding = EmbeddingEMA(n_embed, embedding_dim)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        ema = self.embedding
        zf = z.reshape(-1, self.embedding_dim).float()
        idx = _nearest(zf, ema.weight)
        z_q = ema.weight[idx].reshape(z.shape).to(z.dtype)
        onehot = F.one_hot(idx, self.n_embed).float()
        probs = onehot.mean(dim=0)
        perplexity = torch.exp(-(probs * torch.log(probs + 1e-10)).sum())

        if self.training:
            with torch.no_grad():
                d = self.decay
                cluster_size = ema.cluster_size * d + onehot.sum(dim=0) * (1 - d)
                embed_avg = ema.embed_avg * d + (onehot.t() @ zf.detach()) * (1 - d)
                n = cluster_size.sum()
                smoothed = (cluster_size + self.eps) / (n + self.n_embed * self.eps) * n
                ema.cluster_size.copy_(cluster_size)
                ema.embed_avg.copy_(embed_avg)
                ema.weight.copy_(embed_avg / smoothed[:, None])

        loss = self.beta * ((z_q.detach() - z) ** 2).mean()
        z_q = z + (z_q - z).detach()
        return z_q, {self.loss_key: loss, "encodings": onehot, "encoding_indices": idx,
                     "perplexity": perplexity}

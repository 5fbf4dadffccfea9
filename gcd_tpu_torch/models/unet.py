"""The SVD spatiotemporal VideoUNet with GCD's `aux_label_emb` camera head
(port of gcd_tpu/models/unet.py).

Interface (torch layout, flattened video batch):
    x:         (B*T, in_channels, H, W)   latent + concat-cond channels
    timesteps: (B*T,)                     c_noise from the denoiser
    context:   (B*T, L, context_dim)      crossattn tokens (CLIP image or text)
    y:         (B*T, adm_in_channels + aux_emb_dim); the last aux_emb_dim
               channels (camera embedding) feed `aux_label_emb`
    image_only_indicator: (B, T)
    time_context: (B, Ck) or (B, L, Ck), the temporal blocks' per-video
               context when use_spatial_context is False (optional)
Parameter names are the reference's (model.diffusion_model.* key space).

With `use_checkpoint`, every VideoResBlock and SpatialVideoTransformer call
that records a graph is rematerialised (torch.utils.checkpoint, non-reentrant;
the blocks gcd_tpu/models/unet.py wraps in nn.remat): only the block's
inputs are kept, and its forward runs again in the backward. That recompute
runs on PyTorch's autograd thread, where the caller's kernel switches are
not set, so it re-enters the switches the forward saw (`context_fn`) and
takes the same kernels, and the frame group the forward ran under.

Under a frame group (parallel/frames.py `frame_sharding`) every input still
covers all T frames of its B videos; the network runs on this rank's T / F
frames of each (x's rows, the indicator's columns, the per-frame
conditioning) and returns their rows, (B*T/F, out_channels, H, W). The
embedding and the context reach the blocks whole, for the temporal layers.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import List, Optional, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gcd_tpu_torch.models.layers import GroupNorm32
from gcd_tpu_torch.models.resblock import Downsample, Upsample, VideoResBlock
from gcd_tpu_torch.models.video_attention import SpatialVideoTransformer
from gcd_tpu_torch.ops.basic import timestep_embedding
from gcd_tpu_torch.ops.dispatch import current_flags, kernel_flags
from gcd_tpu_torch.parallel.frames import current_frame_group, frame_sharding, local_frames


@contextmanager
def _recompute_context(flags: dict, fg):
    """The kernel switches and the frame group of a rematerialised block's
    forward, entered where its recompute runs."""
    with kernel_flags(**flags), frame_sharding(fg):
        yield


class VideoUNet(nn.Module):
    """Every option of the JAX package's VideoUNet, with its defaults:
    scale-shift norm, resblock up/down, conv_resample, the conv or linear
    transformer projections, a per-frame or per-video (time_context)
    temporal context, the fixed / learned / learned_with_images blends, any
    video_kernel_size. `time_context_dim` sizes the temporal blocks' context
    layers when use_spatial_context is False (JAX sizes them from the first
    call's time_context); without it they attend over the frames, and a
    time_context they would attend to raises. dims, time_downup,
    num_heads_upsample, dropout and the attention backend's name are
    accepted and unused, as in the JAX package."""

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_resolutions: Sequence[int],
                 dropout: float = 0.0, channel_mult: Sequence[int] = (1, 2, 4, 8),
                 conv_resample: bool = True, dims: int = 2,
                 num_classes: Optional[Union[int, str]] = None,
                 use_checkpoint: bool = False, num_heads: int = -1,
                 num_head_channels: int = -1, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = False, resblock_updown: bool = False,
                 transformer_depth: Union[int, Sequence[int]] = 1,
                 transformer_depth_middle: Optional[int] = None,
                 context_dim: Optional[int] = None, time_downup: bool = False,
                 time_context_dim: Optional[int] = None,
                 extra_ff_mix_layer: bool = False, use_spatial_context: bool = False,
                 merge_strategy: str = "fixed", merge_factor: float = 0.5,
                 spatial_transformer_attn_type: str = "softmax",
                 video_kernel_size: Union[int, Sequence[int]] = 3,
                 use_linear_in_transformer: bool = False,
                 adm_in_channels: Optional[int] = None, aux_emb_dim: int = 0,
                 aux_zero_init: bool = False, disable_temporal_crossattention: bool = False,
                 max_ddpm_temb_period: int = 10000):
        super().__init__()
        if num_classes not in (None, "sequential"):
            raise NotImplementedError(f"num_classes={num_classes!r}: GCD and SVD use "
                                      "'sequential', as the JAX package requires")
        mc = model_channels
        emb_dim = 4 * mc
        depths = ([transformer_depth] * len(channel_mult)
                  if isinstance(transformer_depth, int) else list(transformer_depth))
        depth_middle = (depths[-1] if transformer_depth_middle is None
                        else transformer_depth_middle)
        self.model_channels = mc
        self.use_checkpoint = use_checkpoint
        self.aux_emb_dim = aux_emb_dim
        self.adm_in_channels = adm_in_channels

        self.time_embed = nn.Sequential(nn.Linear(mc, emb_dim), nn.SiLU(),
                                        nn.Linear(emb_dim, emb_dim))
        if num_classes is not None:
            self.label_emb = nn.Sequential(nn.Sequential(
                nn.Linear(adm_in_channels, emb_dim), nn.SiLU(),
                nn.Linear(emb_dim, emb_dim)))
            if aux_emb_dim:
                self.aux_label_emb = nn.Sequential(
                    nn.Linear(aux_emb_dim, emb_dim), nn.SiLU(), nn.Linear(emb_dim, emb_dim))
                if aux_zero_init:
                    for p in self.aux_label_emb.parameters():
                        nn.init.zeros_(p)

        def res(ch_in, ch_out, up=False, down=False):
            return VideoResBlock(ch_in, emb_dim, ch_out, video_kernel_size,
                                 merge_strategy, merge_factor,
                                 use_scale_shift_norm=use_scale_shift_norm, up=up, down=down)

        def attn(ch, depth):
            if num_head_channels == -1:
                n_heads, d_head = num_heads, ch // num_heads
            else:
                n_heads, d_head = ch // num_head_channels, num_head_channels
            return SpatialVideoTransformer(
                ch, n_heads, d_head, depth, context_dim, ff_in=extra_ff_mix_layer,
                merge_strategy=merge_strategy, merge_factor=merge_factor,
                max_time_embed_period=max_ddpm_temb_period,
                use_spatial_context=use_spatial_context,
                use_linear=use_linear_in_transformer,
                disable_temporal_crossattention=disable_temporal_crossattention,
                time_context_dim=time_context_dim)

        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([nn.Conv2d(in_channels, mc, 3, padding=1)])])
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch, depths[level]))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                ds *= 2
                self.input_blocks.append(nn.ModuleList(
                    [res(ch, ch, down=True) if resblock_updown
                     else Downsample(ch, use_conv=conv_resample)]))
                chans.append(ch)

        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch, depth_middle), res(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mc * mult)]
                ch = mc * mult
                if ds in attention_resolutions:
                    layers.append(attn(ch, depths[level]))
                if level and i == num_res_blocks:
                    ds //= 2
                    layers.append(res(ch, ch, up=True) if resblock_updown
                                  else Upsample(ch, use_conv=conv_resample))
                self.output_blocks.append(nn.ModuleList(layers))

        self.out = nn.Sequential(GroupNorm32(ch, silu=True), nn.Identity(),
                                 nn.Conv2d(ch, out_channels, 3, padding=1))

    def _remat(self, block: nn.Module, *args) -> torch.Tensor:
        if not (self.use_checkpoint and torch.is_grad_enabled()):
            return block(*args)
        flags, fg = current_flags(), current_frame_group()
        return checkpoint(block, *args, use_reentrant=False,
                          context_fn=lambda: (nullcontext(), _recompute_context(flags, fg)))

    def _run(self, layers: nn.ModuleList, h, emb, context, t, ioi, time_context):
        for layer in layers:
            if isinstance(layer, VideoResBlock):
                h = self._remat(layer, h, emb, ioi, t)
            elif isinstance(layer, SpatialVideoTransformer):
                h = self._remat(layer, h, context, t, ioi, time_context)
            else:
                h = layer(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                num_video_frames: int = 1,
                image_only_indicator: Optional[torch.Tensor] = None,
                time_context: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.time_embed[0].weight.dtype
        t = num_video_frames
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels).to(dtype))
        if hasattr(self, "label_emb"):
            y = y.to(dtype)
            emb = emb + self.label_emb(y[:, :self.adm_in_channels])
            if self.aux_emb_dim:
                emb = emb + self.aux_label_emb(y[:, self.adm_in_channels:])
        ioi = image_only_indicator
        if ioi is None:
            ioi = torch.zeros(x.shape[0] // t, t, device=x.device)
        fg = current_frame_group()
        if fg is not None:  # this rank's frames
            x, ioi = local_frames(x, t, fg), ioi[:, fg.frame_slice]
        context = None if context is None else context.to(dtype)
        time_context = None if time_context is None else time_context.to(dtype)

        h = x.to(dtype)
        hs: List[torch.Tensor] = []
        for layers in self.input_blocks:
            h = self._run(layers, h, emb, context, t, ioi, time_context)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context, t, ioi, time_context)
        for layers in self.output_blocks:
            h = self._run(layers, torch.cat([h, hs.pop()], dim=1), emb, context, t, ioi,
                          time_context)
        return self.out[2](self.out[0](h))

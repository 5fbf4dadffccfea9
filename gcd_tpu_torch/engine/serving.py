"""Multi-card serving: one clip's UNet evaluations split over a mesh of
processes (port of gcd_tpu/engine/serving.py).

The reference parallelizes inference by replicating the model per GPU and
sharding *examples* across processes (scripts/test.py:1050-1084; the
entries' `--shard i/n`). This shards ONE clip's work across the mesh, one
process a card: every process runs the conditioner, the 25-step sampler
and the VAE decode on the whole clip, and splits each step's UNet
evaluation over the data x fsdp batch ranks by the row rule of
parallel/frames.py (first whole videos of the CFG-doubled batch, then
frame blocks of a video). A rank evaluates its rows and the denoised rows
are all-gathered, so every rank applies the same Euler update to the same
x, and the outputs are the same on every rank (JAX's
`out_shardings=replicate`). Where a frame block meets the rest of its
video (the temporal layers) its video block re-lays its activations with
one all-to-all over its frame group; JAX's GSPMD inserts whatever it
needs there. The initial noise is process 0's, broadcast.

Params are replicated by default (a bf16 UNet fits one card); with a
tensor axis the UNet is cut once, by the Megatron cut sharded training uses
(parallel/tensor.py `cut_unet`, forward only), and the processes of one
tensor group take the same rows.

Where the port departs from JAX, and why (the numbers are the same):
  * the rows: JAX splits the (B*T) axis of the undoubled clip batch over
    data x fsdp where it divides (replicating it where it does not, e.g.
    14 frames on 4 chips) and GSPMD places the doubled batch as it likes;
    the port splits the doubled batch of each UNet call by videos first,
    then by frame blocks, so that at most one all-to-all pair a temporal
    layer crosses cards (none when the videos cover the ranks);
  * the weights: JAX's make_sampler also shards the weights over fsdp when
    mesh_tensor > 1 (scripts/eval_utils.py:534-535); the port keeps them
    whole over data x fsdp, a memory layout, not a different result;
  * the conditioner and the decode run whole on every process (JAX splits
    their batch too); both are small next to 25 UNet evaluations.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import torch
import torch.distributed as dist

from gcd_tpu_torch.models.resblock import Downsample
from gcd_tpu_torch.parallel.frames import (
    FrameGroup,
    describe_rows,
    frame_sharding,
    local_frames,
    sample_rows,
)
from gcd_tpu_torch.parallel.mesh import Mesh, unet_placements
from gcd_tpu_torch.parallel.tensor import cut_unet


def cut_for_tensor(engine, mesh: Mesh) -> None:
    """Cut the engine's UNet over the mesh's tensor axis, once (forward
    only: the layers' tensor groups and the rank's shares of the cut
    projections)."""
    unet = engine.model.diffusion_model
    if mesh.tensor <= 1 or getattr(unet, "tensor_cut", None) is not None:
        return
    cut_unet(unet, unet_placements(unet, 1, mesh.tensor), mesh.coords["tensor"], mesh.tensor,
             mesh.tensor_group)
    unet.tensor_cut = (mesh.coords["tensor"], mesh.tensor)


def unet_planes(h: int, w: int, downsamples: int) -> List[int]:
    """The position counts of the UNet's planes for an (h, w) latent: one
    a level, each of its `downsamples` Downsamples (stride 2, padding 1)
    halving it, rounded up."""
    out = [h * w]
    for _ in range(downsamples):
        h, w = -(-h // 2), -(-w // 2)
        out.append(h * w)
    return out


def make_sharded_sampler(engine, mesh: Mesh, num_steps: Optional[int] = None,
                         decoding_t: Optional[int] = None, return_latents: bool = False,
                         verbose: bool = False) -> Callable[[Dict, Union[torch.Generator, torch.Tensor, None]], Dict]:
    """Returns sample(batch, generator_or_noise) -> dict, over `mesh`.

    The returned callable takes engine.sample_video's batch and either a
    torch.Generator (the noise drawn as sample_video draws it) or the noise
    itself, uses process 0's noise, and runs engine.sample_video with each
    UNet evaluation split over the mesh's batch ranks. Every process gets
    the same outputs, those of sample_video -- including the sampled
    latents when requested. Every process of the mesh must call it, with
    the same batch. With `verbose`, the mesh and the row rule's split of
    each UNet batch are printed the first time it is seen."""
    t = engine.sampler.guider.num_frames
    cut_for_tensor(engine, mesh)
    groups = mesh.frame_groups()
    ranks, coord = mesh.batch_count, mesh.batch_coordinate
    downsamples = sum(isinstance(m, Downsample) for m in engine.model.diffusion_model.modules())
    told = set()

    def denoise(x: torch.Tensor, sigma: torch.Tensor, cond: Dict,
                ioi: torch.Tensor) -> torch.Tensor:
        videos = x.shape[0] // t
        planes = unet_planes(*x.shape[2:], downsamples)
        plan = sample_rows(ranks, videos, t, coord, planes)
        if verbose and (videos, *planes) not in told:
            told.add((videos, *planes))
            print(f"Sampling over {mesh}: {describe_rows(ranks, videos, t, planes)}", flush=True)
        block = slice(plan.video_start * t, plan.video_stop * t)
        fg = None
        if plan.frame_split:
            fg = FrameGroup(groups[(plan.frame_blocks, plan.video_block)], plan.frame_blocks,
                            plan.frame_block, t)
        with frame_sharding(fg):
            mine = engine.denoise(x[block], sigma[block], {k: v[block] for k, v in cond.items()},
                                  ioi[plan.video_start:plan.video_stop],
                                  None if fg is None else lambda v: local_frames(v, t, fg))
        if ranks == 1:
            return mine
        mine = mine.contiguous()
        parts = [torch.empty_like(mine) for _ in range(ranks)]
        dist.all_gather(parts, mine, group=mesh.batch_group)
        # (V, F, videos / V, frames a rank, ...) -> the batch's rows.
        shares = torch.stack(parts).reshape(plan.blocks, plan.frame_blocks,
                                            plan.video_stop - plan.video_start, -1,
                                            *mine.shape[1:])
        if not plan.frame_split:
            shares = shares[:, :1]
        return shares.transpose(1, 2).reshape(x.shape[0], *mine.shape[1:])

    @torch.no_grad()
    def sample(batch: Dict, generator_or_noise: Union[torch.Generator, torch.Tensor, None] = None
               ) -> Dict[str, torch.Tensor]:
        if isinstance(generator_or_noise, torch.Tensor):
            noise = generator_or_noise.to(batch["cond_frames"].device, torch.float32,
                                          memory_format=torch.contiguous_format, copy=True)
        else:
            noise = engine.latent_noise(batch["cond_frames"], generator_or_noise)
        dist.broadcast(noise, src=0)
        return engine.sample_video(batch, noise=noise, num_steps=num_steps,
                                   decoding_t=decoding_t, return_latents=return_latents,
                                   denoise=denoise)

    return sample

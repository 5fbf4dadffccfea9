"""Multi-card serving: one clip's sampling split over a mesh of processes
(port of gcd_tpu/engine/serving.py).

The reference parallelizes inference by replicating the model per GPU and
sharding *examples* across processes (scripts/test.py:1050-1084; the
entries' `--shard i/n`). This shards ONE batch's work across the mesh, one
process a card, as JAX's GSPMD program does, over the data x fsdp batch
ranks:
  * the conditioner: by whole videos, each rank a block of them (with one
    video it runs whole on every rank);
  * each UNet evaluation of the sampler: by the row rule of
    parallel/frames.py (first whole videos of the CFG-doubled batch, then
    frame blocks of a video); a rank evaluates its rows and the denoised
    rows are all-gathered, so every rank applies the same sampler update to
    the same x. Where a frame block meets the rest of its video (the
    temporal layers) its video block re-lays its activations with one
    all-to-all over its frame group; JAX's GSPMD inserts whatever it needs
    there;
  * the VAE decode: by whole chunks of `decoding_t` frames (the video
    decoder's extent; engine/server.py makes a chunk divide a clip, so no
    chunk spans two clips), each rank a block of them (with one chunk, or a
    chunk that does not divide the latents, it runs whole on every rank).
A rank's block of videos or chunks is ceil(items / ranks) of them; the
ranks past the end repeat the last item, so that every all-gather sees
equal shapes, and the repeats are dropped. The outputs are the same on
every rank (JAX's `out_shardings=replicate`). The initial noise, and the
per-step noise of a sampler that draws it, are process 0's, broadcast once.

The weights are placed as JAX's make_sampler places them
(scripts/eval_utils.py:524-535): replicated without a tensor axis (a bf16
UNet fits one card); with one, the UNet is cut by the Megatron cut sharded
training uses (parallel/tensor.py `cut_unet`; the processes of one tensor
group take the same rows) and sharded over the fsdp axis with FSDP2 per
block, forward only, in the engine's own dtype (engine/trainer.py
`fully_shard_unet` without masters; `unet_placements`), each block
gathered for its forward and freed after it.

Where the port departs from JAX, and why (the numbers are the same): JAX
splits the (B*T) axis of the undoubled clip batch over data x fsdp where it
divides (replicating it where it does not, e.g. 14 frames on 4 chips) and
GSPMD places the doubled batch as it likes; the port splits the doubled
batch of each UNet call by videos first, then by frame blocks, so that at
most one all-to-all pair a temporal layer crosses cards (none when the
videos cover the ranks).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from gcd_tpu_torch.engine.engine import UC_ZERO_KEYS
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


def place_weights(engine, mesh: Mesh) -> None:
    """Place the engine's UNet on the mesh, once: with a tensor axis, cut it
    over that axis (forward only: the layers' tensor groups and the rank's
    shares of the cut projections) and shard what JAX's rule shards over
    the fsdp axis, in the UNet's own dtype; otherwise leave it whole."""
    unet = engine.model.diffusion_model
    if mesh.tensor <= 1 or getattr(unet, "tensor_cut", None) is not None:
        return
    from gcd_tpu_torch.engine.trainer import fully_shard_unet

    placements = unet_placements(unet, mesh.fsdp, mesh.tensor)
    cut_unet(unet, placements, mesh.coords["tensor"], mesh.tensor, mesh.tensor_group)
    if mesh.fsdp > 1 and any(pl.fsdp_dim is not None for pl in placements.values()):
        fully_shard_unet(unet, placements, mesh, unet.time_embed[0].weight.dtype,
                         masters=False)
    unet.tensor_cut = (mesh.coords["tensor"], mesh.tensor)


def block_items(items: int, ranks: int, coord: int) -> List[int]:
    """The items (videos, decode chunks) rank `coord` of `ranks` computes: a
    block of ceil(items / ranks), the last item repeated past the end."""
    per = -(-items // ranks)
    return [min(i, items - 1) for i in range(coord * per, (coord + 1) * per)]


def gather_items(local: torch.Tensor, items: int, ranks: int, group) -> torch.Tensor:
    """Every rank's block_items output (`local`: the rows of its items, the
    same count of rows each) all-gathered over `group`, in item order, the
    repeats dropped."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(ranks)]
    dist.all_gather(parts, local, group=group)
    per = -(-items // ranks)
    return torch.cat(parts)[:items * (local.shape[0] // per)]


def _rows(x: torch.Tensor, idx: Sequence[int], n: int) -> torch.Tensor:
    """The rows of items `idx`, `n` rows an item."""
    return torch.cat([x[i * n:(i + 1) * n] for i in idx])


def split_conditioner(engine, mesh: Mesh) -> Callable[[Dict], tuple]:
    """condition(batch) -> (c, uc) of engine.sample_video, the conditioner
    split over the mesh's batch ranks by whole videos."""
    ranks, coord = mesh.batch_count, mesh.batch_coordinate
    keys = engine.conditioner.input_keys

    def condition(batch: Dict):
        videos, t = batch["image_only_indicator"].shape
        if ranks == 1 or videos == 1:
            return engine.get_unconditional_conditioning(batch, UC_ZERO_KEYS)
        idx = block_items(videos, ranks, coord)
        c, uc = engine.get_unconditional_conditioning(
            {k: _rows(batch[k], idx, t) for k in keys}, UC_ZERO_KEYS)
        return tuple({k: gather_items(v, videos, ranks, mesh.batch_group)
                      for k, v in d.items()} for d in (c, uc))

    return condition


def split_decode(engine, mesh: Mesh, decoding_t: Optional[int]) -> Callable:
    """decode(z) -> engine.decode_first_stage(z, decoding_t), split over the
    mesh's batch ranks by whole decode chunks."""
    ranks, coord = mesh.batch_count, mesh.batch_coordinate

    def decode(z: torch.Tensor) -> torch.Tensor:
        n = decoding_t or engine.en_and_decode_n_samples_a_time or z.shape[0]
        chunks = z.shape[0] // n
        if ranks == 1 or chunks <= 1 or z.shape[0] % n:
            return engine.decode_first_stage(z, n)
        idx = block_items(chunks, ranks, coord)
        return gather_items(engine.decode_first_stage(_rows(z, idx, n), n), chunks, ranks,
                            mesh.batch_group)

    return decode


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
                         verbose: bool = False) -> Callable[..., Dict]:
    """Returns sample(batch, generator_or_noise, step_noise=None) -> dict,
    over `mesh`.

    The returned callable takes engine.sample_video's batch and either a
    torch.Generator (the latent noise, then the sampler's per-step noise
    where it draws any, drawn as sample_video draws them) or the latent
    noise itself with the per-step noise in `step_noise`; it uses process
    0's noise, broadcast once before the loop, and runs engine.sample_video
    with each UNet evaluation (a Heun or DPM++ 2S step's second one too)
    split over the mesh's batch ranks. Every process gets
    the same outputs, those of sample_video -- including the sampled
    latents when requested. Every process of the mesh must call it, with
    the same batch. With `verbose`, the mesh and the row rule's split of
    each UNet batch are printed the first time it is seen."""
    place_weights(engine, mesh)
    groups = mesh.frame_groups()
    ranks, coord = mesh.batch_count, mesh.batch_coordinate
    downsamples = sum(isinstance(m, Downsample) for m in engine.model.diffusion_model.modules())
    told = set()
    condition, decode = split_conditioner(engine, mesh), split_decode(engine, mesh, decoding_t)

    def denoise(x: torch.Tensor, sigma: torch.Tensor, cond: Dict,
                ioi: torch.Tensor) -> torch.Tensor:
        t = ioi.shape[1]
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
    def sample(batch: Dict, generator_or_noise: Union[torch.Generator, torch.Tensor, None] = None,
               step_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        device = batch["cond_frames"].device

        def own(t: torch.Tensor) -> torch.Tensor:
            # A contiguous fp32 copy on the batch's device, to broadcast into.
            return t.to(device, torch.float32, memory_format=torch.contiguous_format, copy=True)

        generator = None
        if isinstance(generator_or_noise, torch.Tensor):
            noise = own(generator_or_noise)
        else:
            generator = generator_or_noise
            noise = engine.latent_noise(batch["cond_frames"], generator)
        dist.broadcast(noise, src=0)
        if engine.sampler.needs_step_noise:
            step_noise = own(engine.step_noise(noise, num_steps, generator)
                             if step_noise is None else step_noise)
            dist.broadcast(step_noise, src=0)
        return engine.sample_video(batch, noise=noise, num_steps=num_steps,
                                   decoding_t=decoding_t, return_latents=return_latents,
                                   denoise=denoise, condition=condition, decode=decode,
                                   step_noise=step_noise)

    return sample

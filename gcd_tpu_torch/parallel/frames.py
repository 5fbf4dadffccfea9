"""Frame sharding of one clip's UNet evaluation: the row rule, the frame
groups and the two re-layouts where a video's frames meet (the port's
counterpart of what GSPMD inserts around the temporal layers when
gcd_tpu/engine/serving.py splits the batch's (B*T) axis over the mesh).

The row rule (`sample_rows`). A UNet call sees `videos` videos of T frames
(the CFG-doubled batch holds 2B, a plain step of guidance_interval B). Over
P = data x fsdp batch ranks it splits first by whole videos, into
V = gcd(P, videos) video blocks of videos / V videos each, then each video
block by frames, into F = P / V frame blocks of T / F frames each; batch
rank r holds video block r // F and frame block r % F. Where F does not
divide T, or the positions of one of the UNet's planes, the video block
runs its rows whole on each of its F ranks (`replicated`), as JAX
replicates a leaf whose leading axis the mesh does not divide
(gcd_tpu/parallel/mesh.py:171-174).

A frame group (`FrameGroup`) is the process group of one video block's F
ranks, in frame-block order. Everything per frame runs on the rank's own
frames; the two kinds of site that need every frame of a video (the
`time_stack` of a VideoResBlock and of a SpatialVideoTransformer) are
entered through `frames_to_rows`, one all-to-all over the frame group from
"T / F frames x all positions" to "all T frames x 1 / F of the positions",
and left through `rows_to_frames`, its inverse. The positions split into F
contiguous blocks of the flattened H*W plane: whole rows of H / F when F
divides H, else a (1, H*W / F) plane. The layer between them is per
position (the (3, 1, 1) convs, K2, the cross-attention to a per-video
context), except the GroupNorms' statistics, which are summed over the
group (ops/fused_norm.py `stats_group`).

The frame group of the running call is thread-local (`frame_sharding`,
`current_frame_group`), like the kernel switches (ops/dispatch.py): the
UNet's rematerialised blocks re-enter it for their recompute. Without one,
every helper here is the identity.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """What batch rank `rank` of P computes of a call of `videos` videos of
    `frames` frames: V video blocks, F frame blocks, its video block's videos
    [video_start, video_stop) and its frames [frame_start, frame_stop)
    (all of them when `replicated`)."""
    blocks: int
    frame_blocks: int
    video_block: int
    frame_block: int
    video_start: int
    video_stop: int
    frame_start: int
    frame_stop: int
    replicated: bool

    @property
    def frame_split(self) -> bool:
        """Whether the rank holds only some of its videos' frames."""
        return self.frame_blocks > 1 and not self.replicated


def sample_rows(ranks: int, videos: int, frames: int, rank: int,
                positions: Sequence[int] = ()) -> RowPlan:
    """The row rule (module docstring) for batch rank `rank` of `ranks`;
    `positions` are the position counts of the planes where frames meet.
    Raises on a count below 1 or a rank outside [0, ranks)."""
    if min(ranks, videos, frames) < 1 or not 0 <= rank < ranks:
        raise ValueError(f"sample_rows: rank {rank} of {ranks} ranks, {videos} videos of "
                         f"{frames} frames")
    v = math.gcd(ranks, videos)
    f = ranks // v
    block, index = divmod(rank, f)
    per = videos // v
    replicated = f > 1 and (frames % f != 0 or any(p % f for p in positions))
    local = frames if replicated else frames // f
    start = 0 if replicated else index * local
    return RowPlan(v, f, block, index, block * per, (block + 1) * per, start, start + local,
                   replicated)


def describe_rows(ranks: int, videos: int, frames: int, positions: Sequence[int] = ()) -> str:
    """One line of the rule's split of `videos` videos over `ranks` ranks."""
    plan = sample_rows(ranks, videos, frames, 0, positions)
    what = (f"V={plan.blocks} video blocks x F={plan.frame_blocks} frame blocks, "
            f"{plan.video_stop - plan.video_start} videos x "
            f"{plan.frame_stop - plan.frame_start} frames a rank")
    if plan.replicated:
        what += (f" (F={plan.frame_blocks} does not divide T={frames} or the planes' "
                 f"positions {list(positions)}: each video block runs whole on its "
                 f"{plan.frame_blocks} ranks)")
    return f"{videos} videos over {ranks} batch ranks: {what}"


@dataclasses.dataclass(frozen=True)
class FrameGroup:
    """The `size` ranks of one video block, in frame-block order: this
    rank's block `index` of `frames` (T) frames a video, over `group`."""
    group: object
    size: int
    index: int
    frames: int

    @property
    def local(self) -> int:
        """Frames a video on this rank: T / F."""
        return self.frames // self.size

    @property
    def offset(self) -> int:
        """This rank's first frame."""
        return self.index * self.local

    @property
    def frame_slice(self) -> slice:
        return slice(self.offset, self.offset + self.local)


_tls = threading.local()


@contextmanager
def frame_sharding(fg: Optional[FrameGroup]):
    """The frame group of the UNet calls inside the block (None: none)."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(fg)
    try:
        yield
    finally:
        stack.pop()


def current_frame_group() -> Optional[FrameGroup]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def local_frames(t: torch.Tensor, frames: int, fg: Optional[FrameGroup]) -> torch.Tensor:
    """The rows of this rank's frames of `t`, whose leading axis holds all
    `frames` frames of each of its videos."""
    if fg is None:
        return t
    return t.reshape(-1, frames, *t.shape[1:])[:, fg.frame_slice].reshape(-1, *t.shape[1:])


def _channels_last(x: torch.Tensor) -> bool:
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def _positions(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """x as a 3D tensor in its memory order with the positions flattened,
    and the positions' dimension: tokens (N, S, C) and channels-last images
    (N, H*W, C) at 1, channels-first images (N, C, H*W) at 2."""
    if x.dim() == 3:
        return x.contiguous(), 1
    n, c, h, w = x.shape
    if _channels_last(x):
        return x.permute(0, 2, 3, 1).reshape(n, h * w, c), 1
    return x.contiguous().reshape(n, c, h * w), 2


def _image(m: torch.Tensor, pos_dim: int, hw: Sequence[int]) -> torch.Tensor:
    """The inverse of _positions for an image of spatial shape hw."""
    h, w = hw
    if pos_dim == 1:
        return m.reshape(m.shape[0], h, w, m.shape[2]).permute(0, 3, 1, 2)
    return m.reshape(m.shape[0], m.shape[1], h, w)


def split_plane(hw: Sequence[int], size: int) -> Tuple[int, int]:
    """The spatial shape of one of `size` position blocks of an (H, W)
    plane: (H / F, W) when F divides H, else (1, H*W / F). Raises when F
    does not divide H*W."""
    h, w = hw
    if h % size == 0:
        return h // size, w
    if (h * w) % size:
        raise ValueError(f"{size} frame ranks do not split the {h}x{w} positions")
    return 1, h * w // size


def pack_frames(x: torch.Tensor, frames: int, size: int) -> torch.Tensor:
    """What a rank of `size` sends in frames_to_rows: its (videos * T/F)
    frames' rows cut into `size` position blocks, (F, videos, T/F, ...)."""
    m, pos_dim = _positions(x)
    local = frames // size
    n, a, b = m.shape
    if pos_dim == 1:
        blocks = m.reshape(n // local, local, size, a // size, b).permute(2, 0, 1, 3, 4)
    else:
        blocks = m.reshape(n // local, local, a, size, b // size).permute(3, 0, 1, 2, 4)
    return blocks.contiguous()


def unpack_rows(recv: torch.Tensor, x: torch.Tensor, frames: int, size: int) -> torch.Tensor:
    """frames_to_rows' result from what a rank received, (F, videos, T/F,
    ...): block i from frame rank i; `x` is what the rank sent it from."""
    pos_dim = 1 if x.dim() == 3 or _channels_last(x) else 2
    m = recv.transpose(0, 1).reshape(-1, *recv.shape[3:])
    if x.dim() == 3:
        return m
    return _image(m, pos_dim, split_plane(x.shape[2:], size))


def pack_rows(y: torch.Tensor, frames: int, size: int) -> torch.Tensor:
    """What a rank sends in rows_to_frames: its videos' T frames cut into
    `size` frame blocks, (F, videos, T/F, ...)."""
    m, _ = _positions(y)
    local = frames // size
    return m.reshape(-1, size, local, *m.shape[1:]).transpose(0, 1).contiguous()


def unpack_frames(recv: torch.Tensor, y: torch.Tensor, size: int,
                  hw: Optional[Sequence[int]]) -> torch.Tensor:
    """rows_to_frames' result from what a rank received, (F, videos, T/F,
    ...): position block i from frame rank i; an image of plane `hw`."""
    pos_dim = 1 if y.dim() == 3 or _channels_last(y) else 2
    f, v, local = recv.shape[:3]
    if pos_dim == 1:
        m = recv.permute(1, 2, 0, 3, 4).reshape(v * local, f * recv.shape[3], recv.shape[4])
    else:
        m = recv.permute(1, 2, 3, 0, 4).reshape(v * local, recv.shape[3], f * recv.shape[4])
    return m if y.dim() == 3 else _image(m, pos_dim, hw)


def _exchange(send: torch.Tensor, fg: FrameGroup) -> torch.Tensor:
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=fg.group)
    return recv


def frames_to_rows(x: torch.Tensor, fg: Optional[FrameGroup]) -> torch.Tensor:
    """This rank's frames (videos * T/F rows) of an image (N, C, H, W) or
    tokens (N, S, C) -> all T frames of its videos at its block of the
    positions: (videos * T, C, *split_plane) or (videos * T, S / F, C).
    An image keeps its memory layout (channels-last or contiguous)."""
    if fg is None:
        return x
    return unpack_rows(_exchange(pack_frames(x, fg.frames, fg.size), fg), x, fg.frames,
                       fg.size)


def rows_to_frames(y: torch.Tensor, fg: Optional[FrameGroup],
                   hw: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The inverse of frames_to_rows; `hw` is the image's whole plane."""
    if fg is None:
        return y
    return unpack_frames(_exchange(pack_rows(y, fg.frames, fg.size), fg), y, fg.size, hw)


def position_block(x: torch.Tensor, size: int, index: int) -> torch.Tensor:
    """Single-process model of frames_to_rows: position block `index` of
    `size` of a whole tensor (every frame of its videos), as rank `index`
    holds it after the re-layout."""
    if x.dim() == 3:
        s = x.shape[1] // size
        return x[:, index * s:(index + 1) * s]
    h, w = x.shape[2:]
    sh, sw = split_plane((h, w), size)
    flat = x.reshape(x.shape[0], x.shape[1], h * w)[..., index * sh * sw:(index + 1) * sh * sw]
    return flat.reshape(x.shape[0], x.shape[1], sh, sw)


def halo_fits(hw: Sequence[int], size: int, rows: int) -> bool:
    """Whether position blocks of an (H, W) plane over `size` ranks are row
    bands of at least `rows` rows, so a conv reading `rows` rows past its
    block takes them from the neighbouring bands alone."""
    return hw[0] % size == 0 and hw[0] // size >= rows


def halo_rows(x: torch.Tensor, fg: FrameGroup, rows: int) -> torch.Tensor:
    """x (B, C, T, h, W), this rank's band of h rows of every frame (its
    frames_to_rows block of a plane whose rows the group divides) -> (B, C,
    T, h + 2 rows, W): `rows` rows of the bands above and below, from the
    neighbouring ranks of the group (one all-gather of every rank's edges),
    zeros past the plane's top and bottom."""
    edges = torch.stack((x[..., :rows, :], x[..., -rows:, :])).contiguous()
    got = [torch.empty_like(edges) for _ in range(fg.size)]
    dist.all_gather(got, edges, group=fg.group)
    zero = torch.zeros_like(edges[0])
    above = got[fg.index - 1][1] if fg.index > 0 else zero
    below = got[fg.index + 1][0] if fg.index + 1 < fg.size else zero
    return torch.cat((above, x, below), dim=3)


def gather_frames(x: torch.Tensor, fg: FrameGroup) -> torch.Tensor:
    """This rank's frames of an image (videos * T/F, C, H, W) -> every frame
    of its videos (videos * T, C, H, W), contiguous, all-gathered over the
    frame group."""
    x = x.contiguous()
    got = [torch.empty_like(x) for _ in range(fg.size)]
    dist.all_gather(got, x, group=fg.group)
    videos = x.shape[0] // fg.local
    return (torch.stack(got).reshape(fg.size, videos, fg.local, *x.shape[1:])
            .transpose(0, 1).reshape(videos * fg.frames, *x.shape[1:]))


def all_reduce_sums(s1: torch.Tensor, s2: torch.Tensor, group) -> Tuple[torch.Tensor,
                                                                         torch.Tensor]:
    """(sum x, sum x^2) summed over `group`, in one all-reduce."""
    both = torch.stack((s1, s2))
    dist.all_reduce(both, group=group)
    return both[0], both[1]

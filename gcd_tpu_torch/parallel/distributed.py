"""Training across processes (port of gcd_tpu/parallel/distributed.py),
on torch.distributed.

The conventions are the JAX package's:
  * the config's `batch_size` is the global batch: it splits over the
    data x fsdp axes of the mesh (parallel/mesh.py), so the process at row
    block c of P = data x fsdp blocks loads rows [c*B/P, (c+1)*B/P) of every
    global batch (data/loader.py `process_shard`), and P blocks consume the
    one-process run's examples; the processes of one tensor group load the
    same rows;
  * every process draws the global batch's random numbers from the same
    seed and keeps its block's rows (engine/trainer.py), and the fp32
    gradients are averaged over data x fsdp (JAX's psum), so any mesh makes
    the one-process run's steps up to the order of the sums;
  * the config snapshot, the metrics CSV, wandb, the checkpoints and the
    image log are written by process 0 only; every process restores.

Without --mesh_fsdp / --mesh_tensor every process holds a full replica
(data parallelism); with them the fsdp axis shards the UNet's parameters
and the tensor axis cuts its attention and feed-forward projections
(engine/trainer.py, parallel/tensor.py).

The group is NCCL on CUDA and gloo for `--device cpu`; a failed
initialisation raises, it never falls back to the other. Given a
coordinator, the group is formed even for one process, so the NCCL path
runs on a one-card machine too.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

# How long a collective may wait for the slowest process (an image log on
# process 0, a checkpoint write) before it fails.
TIMEOUT = datetime.timedelta(minutes=30)


def check_mesh(num_processes: int, fsdp: int, tensor: int) -> None:
    """Raise unless `num_processes` divides by fsdp x tensor (the data axis
    takes what they leave)."""
    if fsdp < 1 or tensor < 1:
        raise ValueError(f"--mesh_fsdp {fsdp} / --mesh_tensor {tensor} must be >= 1")
    if num_processes % (fsdp * tensor):
        raise ValueError(f"--num_processes {num_processes} does not divide by --mesh_fsdp "
                         f"{fsdp} x --mesh_tensor {tensor}")


def check_sampling_mesh(num_processes: int, data: int, fsdp: int, tensor: int) -> None:
    """Raise unless the sampling mesh data x fsdp x tensor (the inference
    entries' --mesh_* flags, each at least 1) is the process count."""
    if min(data, fsdp, tensor) < 1:
        raise ValueError(f"--mesh_data {data} / --mesh_fsdp {fsdp} / --mesh_tensor {tensor} "
                         "must be >= 1")
    if data * fsdp * tensor != num_processes:
        raise ValueError(f"the mesh --mesh_data {data} x --mesh_fsdp {fsdp} x --mesh_tensor "
                         f"{tensor} = {data * fsdp * tensor} processes, but --num_processes "
                         f"is {num_processes}")


def check_batch(batch_size: int, blocks: int) -> None:
    """Raise unless the global batch splits over `blocks` = data x fsdp."""
    if batch_size % blocks:
        raise ValueError(f"the global batch of {batch_size} does not split over data x fsdp "
                         f"= {blocks} row blocks")


def initialize(coordinator: Optional[str], num_processes: int, process_id: int,
               device: torch.device) -> bool:
    """Join the process group of `num_processes` processes at
    `coordinator` (host:port of process 0), as process `process_id`; on
    CUDA first select card process_id % the host's card count. No
    coordinator and at most one process: no group. Returns whether a group
    was formed."""
    if not coordinator:
        if num_processes > 1:
            raise ValueError(f"--num_processes {num_processes} needs --coordinator host:port")
        return False
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} of --num_processes {num_processes}")
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)
    return True


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    return process_index() == 0


def broadcast_str(s: str) -> str:
    """Process 0's `s` on every process (the run directory's timestamped
    name, which would otherwise differ between processes)."""
    if not dist.is_initialized():
        return s
    box = [s]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_reduce_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """`t` averaged over the processes of `group` (all of them when None),
    in place (a no-op without a process group); returns `t`."""
    if dist.is_initialized():
        dist.all_reduce(t, group=group)
        t.div_(dist.get_world_size(group))
    return t

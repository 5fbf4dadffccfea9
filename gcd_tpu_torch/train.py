"""The training entry of the port (counterpart of main.py:28-385).

    python -m gcd_tpu_torch.train -b configs/train_kubric_max90.yaml \
        data.params.dset_root=/data/Kubric-4D/data data.params.pcl_root=/data/Kubric-4D/pcl
    python -m gcd_tpu_torch.train --resume logs/<run>            # on from its last checkpoint
    python -m gcd_tpu_torch.train --device cpu -b configs/smoke_kubric_tiny.yaml \
        data.params.dset_root=... data.params.pcl_root=...
    # over N processes (one per card, or gloo with --device cpu), data-parallel,
    # or with the UNet sharded over F (fsdp) and cut over TP (tensor):
    python -m gcd_tpu_torch.train ... --coordinator host:port --num_processes N --process_id P \
        [--mesh_fsdp F] [--mesh_tensor TP]

Configs merge left to right, then the `key.path=value` overrides; the run
directory {logdir}/{date}_{name} holds configs/ (the merged config),
checkpoints/step_N (io/checkpoint.py: module weights, fp32 masters,
optimizer state, step, and the EMA, the accumulated gradient and the update
count when the run has them), metrics.csv and images/train
(engine/image_logger.py). A checkpoint is written every
`lightning.modelcheckpoint.params.every_n_train_steps` steps and at the
end, and on SIGUSR1 or an exception ("melk"). `--resume` restores the
latest checkpoint of a run; the loader starts again at epoch 0, as
main.py's does. `--resume_from_checkpoint` (or `model.params.ckpt_path`)
starts from released weights instead.

The training options are the trainer's (engine/trainer.py):
`model.params.use_ema`, `model.params.scheduler_config` (the CSV's `lr` is
main.py's `schedule(global_step)`), `model.params.ft_strategy: time_lora`
and `lightning.trainer.accumulate_grad_batches`; a step of the CSV is a
micro-step. With `--coordinator` the processes form one torch.distributed
group (parallel/distributed.py; NCCL on CUDA, gloo with `--device cpu`,
formed even for one process): `batch_size` is the global batch, each
process renders its rows, the gradients are averaged, all agree on the run
directory, and process 0 alone writes the config snapshot, the CSV, wandb,
the checkpoints and the image log (sampled from its full replica while the
others go on to the next step's reduction); every process restores.
`--scale_lr` multiplies the rate by accumulate x processes x batch size.
`--mesh_fsdp F` / `--mesh_tensor TP` lay the N processes out as JAX's mesh
(parallel/mesh.py; data = N / (F x TP)): the global batch splits over data
x fsdp, the UNet's parameters shard over fsdp (FSDP2) and its attention and
feed-forward projections are cut over tensor (parallel/tensor.py), as the
trainer says (engine/trainer.py). Process 0 prints the mesh and the
placement summary (parameters and bytes sharded, cut and replicated, the
layers left uncut). On such a mesh every process gathers the checkpoints
whole (the one format: any mesh resumes any run's checkpoint) and samples
the image log, and melk on an exception is skipped (the failed process
cannot join the gather; SIGUSR1 sent to every process still saves).

The data module (data/kubric.py) renders the batches on host threads while
the card trains; `batch_to_device` copies each through pinned memory. The
step's random numbers come from one torch.Generator on the device, seeded
from `--seed` and the step's index (JAX's fold_in has no counterpart, so the
losses are not main.py's). On CUDA, in bf16 with fp32 masters
(engine/trainer.py), unless `--device cpu` asks for the CPU (fp32); without
CUDA and without that flag it raises.

`main(argv)` returns what the run measured (losses, step and loader-wait
seconds, kernel launches per step, checkpoint sizes and seconds) with its
trainer; `setup` and `fit` are its two halves (`main` leaves the process
group it formed; a caller of `setup` and `fit` calls
`distributed.shutdown()`).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import datetime
import glob
import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from gcd_tpu_torch.data.loader import batch_to_device
from gcd_tpu_torch.engine.build import engine_from_config
from gcd_tpu_torch.engine.image_logger import ImageLogger
from gcd_tpu_torch.engine.trainer import DEFAULT_LEARNING_RATE, Trainer
from gcd_tpu_torch.io.checkpoint import (UNET_PREFIX, checkpoint_state_dict, find_resume_logdir,
                                         latest_step, restore_checkpoint, save_checkpoint,
                                         split_ema)
from gcd_tpu_torch.ops import KERNELS
from gcd_tpu_torch.parallel import distributed
from gcd_tpu_torch.parallel.mesh import create_mesh, placement_summary, unet_placements
from gcd_tpu_torch.utils.config import (apply_dotlist, config_to_dict, get_by_path,
                                        instantiate_from_config, load_config, merge_configs,
                                        save_config)

# Offset of the image log's generator seed from the step's (main.py's
# fold_in(key, 2**30 + step)).
IMAGE_LOG_SEED_OFFSET = 2 ** 30


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="gcd_tpu_torch trainer")
    parser.add_argument("-n", "--name", type=str, default="")
    parser.add_argument("-r", "--resume", type=str, default="")
    parser.add_argument("-b", "--base", nargs="*", default=[])
    parser.add_argument("-s", "--seed", type=int, default=23)
    parser.add_argument("-l", "--logdir", type=str, default="logs")
    parser.add_argument("--scale_lr", action="store_true", default=False)
    parser.add_argument("--resume_from_checkpoint", type=str, default="")
    parser.add_argument("--max_steps", type=int, default=-1)
    parser.add_argument("--wandb", action="store_true", default=False)
    parser.add_argument("--projectname", type=str, default="gcd_tpu")
    parser.add_argument("--no_date", action="store_true", default=False)
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="torch.profiler trace of steps 2..2+N under <logdir>/profile")
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' to train on the CPU (fp32); default: the CUDA card (bf16)")
    parser.add_argument("--coordinator", type=str, default="",
                        help="host:port of process 0: train data-parallel in one "
                        "torch.distributed group (formed even for one process)")
    parser.add_argument("--num_processes", type=int, default=1)
    parser.add_argument("--process_id", type=int, default=0)
    parser.add_argument("--mesh_fsdp", type=int, default=1,
                        help="fsdp axis size: shard the UNet's parameters over F processes")
    parser.add_argument("--mesh_tensor", type=int, default=1,
                        help="tensor axis size: cut the UNet's projections over TP processes")
    return parser


class CSVLogger:
    """{logdir}/metrics.csv, one row per step (appended to on resume)."""

    def __init__(self, logdir: str):
        self.path = os.path.join(logdir, "metrics.csv")
        self._file = open(self.path, "a", newline="")
        self._writer = None

    def log(self, metrics: Dict) -> None:
        if self._writer is None:
            self._writer = csv.DictWriter(self._file, fieldnames=list(metrics))
            if self._file.tell() == 0:
                self._writer.writeheader()
        self._writer.writerow(metrics)
        self._file.flush()

    def close(self) -> None:
        self._file.close()


def checkpoint_state(trainer: Trainer) -> Dict[str, Any]:
    """What a checkpoint holds: the module weights with the EMA shadow under
    LitEma's names, then the rest of Trainer.state_dict()."""
    state = trainer.state_dict()
    return {"module": {**trainer.module_state_dict(), **state.pop("ema", {})}, **state}


def step_seed(seed: int, step: int) -> int:
    """The generator seed of step `step` of a run seeded with `seed`."""
    return seed * 2 ** 32 + step


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


@dataclasses.dataclass
class Run:
    """What `setup` builds and `fit` trains."""
    opt: argparse.Namespace
    logdir: str
    ckptdir: str
    device: torch.device
    trainer: Trainer
    loader: Any
    image_logger: ImageLogger
    csv_logger: Optional[CSVLogger]
    wandb_run: Any
    lr: float
    ckpt_every: int
    max_epochs: int
    start_step: int
    restore_seconds: Optional[float]
    owns_group: bool

    def log_metrics(self, metrics: Dict) -> None:
        if self.csv_logger is not None:
            self.csv_logger.log(metrics)
        if self.wandb_run is not None:
            self.wandb_run.log(metrics, step=metrics.get("step"))


def setup(argv: Optional[List[str]] = None) -> Run:
    """Parse, join the process group when asked, assemble the config and
    the run directory, build the data module, the engine and the trainer,
    and restore the run's latest checkpoint on `--resume`."""
    opt, unknown = get_parser().parse_known_args(argv)
    distributed.check_mesh(opt.num_processes, opt.mesh_fsdp, opt.mesh_tensor)
    if opt.device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("gcd_tpu_torch.train: no CUDA device; pass --device cpu to "
                               "train on the CPU")
        opt.device = "cuda"
    owns_group = distributed.initialize(opt.coordinator, opt.num_processes, opt.process_id,
                                        torch.device(opt.device))
    try:
        return _setup(opt, unknown, owns_group)
    except BaseException:
        if owns_group:
            distributed.shutdown()
        raise


def _setup(opt: argparse.Namespace, unknown: List[str], owns_group: bool) -> Run:
    device = torch.device(opt.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    nproc, is_main = distributed.process_count(), distributed.is_main()

    # ---- config assembly (main.py:134-161) -------------------------------
    if opt.resume:
        logdir = find_resume_logdir(opt.resume)
        opt.base = sorted(glob.glob(os.path.join(logdir, "configs", "*.yaml"))) + opt.base
    else:
        now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
        cfg_name = os.path.splitext(os.path.basename(opt.base[0]))[0] if opt.base else "none"
        name = opt.name or cfg_name
        # Every process must write into process 0's (timestamped) directory.
        logdir = os.path.join(opt.logdir, distributed.broadcast_str(
            name if opt.no_date else f"{now}_{name}"))
    config = apply_dotlist(merge_configs([load_config(fp) for fp in opt.base]),
                           [u for u in unknown if "=" in u])
    ckptdir = os.path.join(logdir, "checkpoints")
    cfgdir = os.path.join(logdir, "configs")
    os.makedirs(ckptdir, exist_ok=True)
    os.makedirs(cfgdir, exist_ok=True)
    if is_main:
        save_config(config, os.path.join(
            cfgdir, f"{datetime.datetime.now():%Y-%m-%dT%H-%M-%S}-project.yaml"))
    np.random.seed(opt.seed)

    model_cfg = dict(config["model"])
    params = model_cfg.get("params") or {}
    base_lr = float(model_cfg.get("base_learning_rate", DEFAULT_LEARNING_RATE))

    frame_h = int(get_by_path(config, "data.params.frame_height", 256))
    frame_w = int(get_by_path(config, "data.params.frame_width", 384))
    t = int(get_by_path(config, "data.params.model_frames", 14))
    batch_size = int(get_by_path(config, "data.params.batch_size", 1))
    fsdp, tensor = opt.mesh_fsdp, opt.mesh_tensor
    blocks = nproc // tensor  # data x fsdp row blocks of the global batch
    distributed.check_batch(batch_size, blocks)
    mesh = create_mesh(-1, fsdp, tensor, device.type) if fsdp * tensor > 1 else None
    if is_main and mesh is not None:
        print(f"Mesh: {mesh.shape} over {nproc} process(es)")
    data_module = instantiate_from_config(config["data"])
    loader = data_module.train_dataloader()
    if blocks > 1:
        loader.process_shard = (mesh.batch_coordinate if mesh is not None
                                else distributed.process_index(), blocks)

    lightning_cfg = config.get("lightning", {})
    trainer_cfg = lightning_cfg.get("trainer", {})
    accumulate = int(trainer_cfg.get("accumulate_grad_batches", 1))
    max_epochs = int(trainer_cfg.get("max_epochs", 300))
    ckpt_every = int(get_by_path(lightning_cfg, "modelcheckpoint.params.every_n_train_steps",
                                 1250))
    img_logger_cfg = get_by_path(lightning_cfg, "callbacks.image_logger.params", {}) or {}
    image_logger = ImageLogger(logdir, **{
        k: v for k, v in img_logger_cfg.items()
        if k in ("batch_frequency", "disabled", "log_first_step")})
    csv_logger = CSVLogger(logdir) if is_main else None
    wandb_run = None
    if opt.wandb and is_main:
        try:
            import wandb

            wandb_run = wandb.init(project=opt.projectname, name=os.path.basename(logdir),
                                   dir=logdir, config=config_to_dict(config))
        except ImportError:
            print("wandb requested but not installed; using CSV logger only")

    # ---- LR scaling (main.py:222-229) ------------------------------------
    if opt.scale_lr:
        lr = accumulate * nproc * batch_size * base_lr
        print(f"Scaling LR to {lr:.2e} = {accumulate} x {nproc} x {batch_size} x "
              f"{base_lr:.2e}")
    else:
        lr = base_lr

    # ---- model and trainer -----------------------------------------------
    print(f"Initializing parameters ({frame_h}x{frame_w}, T={t}) on {device}, process "
          f"{distributed.process_index()} of {nproc}...")
    resume_step = latest_step(ckptdir) if opt.resume else None
    restored, restore_seconds = None, None
    if resume_step is not None:
        t0 = time.perf_counter()
        restored = restore_checkpoint(ckptdir, resume_step)
        weights, ema = split_ema(restored["module"])
        if ema:
            restored["ema"] = ema
        engine = engine_from_config(model_cfg, device, dtype, weights)
    else:
        ckpt_path = opt.resume_from_checkpoint or params.get("ckpt_path")
        state_dict = None
        if ckpt_path and os.path.exists(str(ckpt_path)):
            print(f"Loading torch checkpoint {ckpt_path}...")
            state_dict = checkpoint_state_dict(
                str(ckpt_path), use_ema=bool(params.get("ckpt_has_ema", False)),
                ablate_unet_scratch=bool(params.get("ablate_unet_scratch", False)),
                verbose=True)
        engine = engine_from_config(model_cfg, device, dtype, state_dict,
                                    strict=state_dict is None)
    placements = None
    if mesh is not None:
        unet = engine.model.diffusion_model
        placements = unet_placements(unet, fsdp, tensor)
        if is_main:
            summary = placement_summary(unet, placements, fsdp, tensor,
                                        [n[len(UNET_PREFIX):] for n in
                                         engine.trainable_parameter_names()
                                         if n.startswith(UNET_PREFIX)])
            print(f"Placement: {json.dumps(summary)}")
    trainer = Trainer(engine, lr, accumulate, mesh=mesh, placements=placements)
    start_step = 0
    if restored is not None:
        print(f"Resuming from {ckptdir} step {resume_step}")
        trainer.load_state_dict(restored)
        if device.type == "cuda":
            torch.cuda.synchronize()
        restore_seconds = time.perf_counter() - t0
        start_step = trainer.global_step
        del restored
    return Run(opt=opt, logdir=logdir, ckptdir=ckptdir, device=device,
               trainer=trainer, loader=loader, image_logger=image_logger,
               csv_logger=csv_logger, wandb_run=wandb_run, lr=lr, ckpt_every=ckpt_every,
               max_epochs=max_epochs, start_step=start_step, restore_seconds=restore_seconds,
               owns_group=owns_group)


def _timed(loader):
    """(seconds the caller waited for the batch, batch) over one epoch."""
    it = iter(loader)
    try:
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            yield time.perf_counter() - t0, batch
    finally:
        it.close()


def fit(run: Run) -> Dict[str, Any]:
    """Train to `--max_steps` (or `max_epochs`), checkpointing and logging
    as main.py does. Returns the run's measurements and its trainer."""
    opt, trainer, device = run.opt, run.trainer, run.device
    stats: Dict[str, Any] = {
        "logdir": run.logdir, "trainer": trainer, "start_step": run.start_step,
        "restore_seconds": run.restore_seconds, "steps": [], "losses": [],
        "step_seconds": [], "loader_wait_seconds": [], "launches": [], "saves": [],
        "image_logs": []}
    saved_step = [None]
    is_main = distributed.is_main()
    # A mesh that cuts or shards the UNet: the checkpoint and the image log
    # are collectives.
    sharded = bool(trainer.layouts)

    def save() -> None:
        # Process 0 writes. Without a sharded mesh every process holds the
        # same state, a part-accumulated mean included (engine/trainer.py),
        # so melk's save on process 0 alone is as exact as a periodic one;
        # with one, every process joins the gather.
        saved_step[0] = trainer.global_step
        if not (is_main or sharded):
            return
        t0 = time.perf_counter()
        state = checkpoint_state(trainer)
        if not is_main:
            return
        path = save_checkpoint(run.ckptdir, trainer.global_step, state)
        del state
        stats["saves"].append({"step": trainer.global_step,
                               "seconds": time.perf_counter() - t0,
                               "bytes": sum(os.path.getsize(p) for p in
                                            glob.glob(os.path.join(path, "*")))})

    def melk(*args):
        if sharded and not args:
            if is_main:
                print("Not saving on the exception: a sharded state needs every process")
            return
        if is_main:
            print("Saving checkpoint on interrupt/exception (melk)...")
        save()
        if args:
            sys.exit(1)

    on_main_thread = threading.current_thread() is threading.main_thread()
    previous_handler = signal.signal(signal.SIGUSR1, melk) if on_main_thread else None
    gen = torch.Generator(device)
    log_gen = torch.Generator(device)
    max_steps = opt.max_steps if opt.max_steps > 0 else None
    prof = None
    if is_main:
        print(f"Training from step {trainer.global_step} (ckpt every {run.ckpt_every})...")
    try:
        done = False
        for epoch in range(run.max_epochs):
            if done:
                break
            for wait_s, batch_np in _timed(run.loader):
                if is_main and opt.profile_steps > 0 and trainer.global_step == 2:
                    prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        *([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda"
                          else [])])
                    prof.start()
                if prof is not None and trainer.global_step == 2 + opt.profile_steps:
                    prof.stop()
                    os.makedirs(os.path.join(run.logdir, "profile"), exist_ok=True)
                    prof.export_chrome_trace(os.path.join(run.logdir, "profile", "trace.json"))
                    print(f"profiler trace written to {run.logdir}/profile")
                    prof = None
                step_t0 = time.perf_counter()
                batch = batch_to_device(batch_np, device)
                gen.manual_seed(step_seed(opt.seed, trainer.global_step))
                before = launch_counts()
                metrics = trainer.train_step(batch, gen)
                loss = float(metrics["loss"])
                grad_norm = float(metrics["grad_norm"])
                dt = time.perf_counter() - step_t0
                global_step = trainer.global_step
                after = launch_counts()
                stats["steps"].append(global_step)
                stats["losses"].append(loss)
                stats["step_seconds"].append(dt)
                stats["loader_wait_seconds"].append(wait_s)
                stats["launches"].append({k: after[k] - before[k] for k in after})
                if is_main and (global_step % 10 == 0 or global_step <= 5):
                    print(f"step {global_step} epoch {epoch} loss {loss:.4f} ({dt:.2f}s/it, "
                          f"{wait_s:.2f}s waiting for data)")
                run.log_metrics({"step": global_step, "epoch": epoch, "loss": loss,
                                 "grad_norm": grad_norm, "lr": trainer.lr_at(global_step)})

                if (is_main or sharded) and run.image_logger.should_log(global_step):
                    try:
                        t0 = time.perf_counter()
                        log_gen.manual_seed(step_seed(opt.seed,
                                                      IMAGE_LOG_SEED_OFFSET + global_step))
                        prefix = run.image_logger.log(trainer.engine, batch_np, global_step,
                                                      log_gen, write=is_main)
                        if is_main:
                            stats["image_logs"].append({"step": global_step, "prefix": prefix,
                                                        "seconds": time.perf_counter() - t0})
                    except Exception:  # a failed image log does not stop training
                        print("image logging failed:")
                        traceback.print_exc()

                if global_step % run.ckpt_every == 0:
                    save()
                if max_steps is not None and global_step >= max_steps:
                    done = True
                    break
    except Exception:
        melk()
        raise
    finally:
        if prof is not None:
            prof.stop()
        if on_main_thread:
            signal.signal(signal.SIGUSR1, previous_handler)
        if run.csv_logger is not None:
            run.csv_logger.close()

    if saved_step[0] != trainer.global_step:
        save()
    stats["global_step"] = trainer.global_step
    if is_main:
        print(f"Training finished at step {trainer.global_step}; logdir: {run.logdir}")
    return stats


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    run = setup(argv)
    try:
        return fit(run)
    finally:
        if run.owns_group:
            distributed.shutdown()


if __name__ == "__main__":
    main()

"""Data-parallel training across processes (gcd_tpu_torch/parallel/
distributed.py) on the CPU: two processes in a gloo group through
`python -m gcd_tpu_torch.train --device cpu`, as a user starts them on two
hosts, against the one-process run, with every training option on
(time_lora, EMA, a LambdaLinearScheduler, two accumulated micro-steps).

configs/smoke_kubric_tiny.yaml on the tiny synthetic root of
gcd_tpu_torch/data/fake.py, the global batch of 2 clips split one clip a
process. Each process draws the global batch's random numbers and keeps its
rows, the gradients are averaged on every micro-step, so the per-step
losses equal the one-process run's up to the order of the fp32 sums, 1e-6
relative (JAX's own two-process test measured 6e-8), and so do the grad
norms, whose backward sums over the batch run in another order, 1e-5
relative (1.5e-6 measured on the CPU), and the accumulated gradient, whose
small entries cancel, 1e-4 relative L2 as tests/test_torch_train_step.py
holds gradients (3.6e-5 measured; the mean of two half-batch gradients in
one process differs from the whole batch's by 1.5e-5). A
checkpoint at step 3 falls in the middle of an accumulation: process 0
writes it with no collective (as melk does), and its running mean is the
one-process run's. Every process runs on one PyTorch intra-op
thread (the test workers share the host's cores).
"""

import csv
import glob
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from gcd_tpu_torch import train
from gcd_tpu_torch.data.fake import make_kubric_root
from gcd_tpu_torch.io.checkpoint import latest_step, restore_checkpoint
from gcd_tpu_torch.parallel import distributed
from tests.torch_port_helpers import REPO, TINY_CONFIG

STEPS, RESUME_STEPS = 4, 6
OPTIONS = [
    "model.params.ft_strategy=time_lora", "model.params.use_ema=true",
    "model.params.scheduler_config={target: sgm.lr_scheduler.LambdaLinearScheduler, params: "
    "{warm_up_steps: [2], cycle_lengths: [100], f_start: [0.1], f_max: [1.0], f_min: [0.5]}}",
    "lightning.trainer.accumulate_grad_batches=2",
    "lightning.modelcheckpoint.params.every_n_train_steps=3"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _args(root, logdir, *extra):
    return ["--device", "cpu", "-b", TINY_CONFIG, "-l", logdir, "-n", "dp", "--no_date",
            f"data.params.dset_root={root}/data", f"data.params.pcl_root={root}/pcl",
            *OPTIONS, *extra]


def _launch(args, nproc):
    """`nproc` processes of the entry in one gloo group, started together."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONSTARTUP", None)
    return [subprocess.Popen(
        [sys.executable, "-m", "gcd_tpu_torch.train", *args, "--coordinator",
         f"127.0.0.1:{port}", "--num_processes", str(nproc), "--process_id", str(pid)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nproc)]


def _wait(procs):
    outs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=240)
            outs.append(out)
    finally:
        for proc in procs:
            proc.kill()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-3000:]
    return outs


def _rows(logdir):
    with open(os.path.join(logdir, "metrics.csv"), newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two processes to step 4 (started first, they run beside the
    one-process run in this process), then two processes resumed to 6."""
    tmp = tmp_path_factory.mktemp("distributed")
    root = str(tmp / "kubric")
    make_kubric_root(root)
    two = str(tmp / "two")
    procs = _launch(_args(root, two, "--max_steps", str(STEPS),
                          "lightning.callbacks.image_logger.params.batch_frequency=2"), 2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = train.main(_args(root, str(tmp / "one"), "--max_steps", str(STEPS),
                               "lightning.callbacks.image_logger.params.disabled=true"))
    finally:
        torch.set_num_threads(threads)
    outs = _wait(procs)
    resumed = _wait(_launch(["--device", "cpu", "--resume", os.path.join(two, "dp"),
                             "--max_steps", str(RESUME_STEPS)], 2))
    return dict(one=one, two=os.path.join(two, "dp"), outs=outs, resumed=resumed)


def test_two_processes_take_the_one_process_steps(runs):
    one = runs["one"]
    rows = _rows(runs["two"])[:STEPS]
    assert [int(r["step"]) for r in rows] == one["steps"] == list(range(1, STEPS + 1))
    two = np.array([float(r["loss"]) for r in rows])
    np.testing.assert_allclose(two, one["losses"], rtol=1e-6, atol=0)
    assert len(set(one["losses"])) == STEPS
    norms = [float(r["grad_norm"]) for r in _rows(one["logdir"])]
    np.testing.assert_allclose([float(r["grad_norm"]) for r in rows], norms, rtol=1e-5, atol=0)
    assert len(set(norms)) == STEPS
    trainer = one["trainer"]
    assert trainer.updates == STEPS // 2 and trainer.ema.num_updates == STEPS
    for out, pid in zip(runs["outs"], (0, 1)):
        assert f"process {pid} of 2" in out


def test_process_zero_alone_writes(runs):
    """One CSV writer (each step's row once), a config snapshot a run, one
    image-log writer, the checkpoints written by process 0 only."""
    two = runs["two"]
    assert [int(r["step"]) for r in _rows(two)] == list(range(1, RESUME_STEPS + 1))
    assert len(glob.glob(os.path.join(two, "configs", "*.yaml"))) == 2
    assert all("Training finished" not in out for out in (runs["outs"][1], runs["resumed"][1]))
    assert "Training finished at step 4" in runs["outs"][0]
    logs = sorted(os.listdir(os.path.join(two, "images", "train")))
    assert [n.split("_")[0] for n in logs if n.endswith(".npz")] == [
        "gs-0000002", "gs-0000004", "gs-0000006"]
    assert not glob.glob(os.path.join(two, "checkpoints", ".step_*"))


def test_mid_accumulation_checkpoint_holds_the_global_mean(runs):
    """Step 3 is micro-step 1 of 2: process 0's running mean, saved without
    a collective, is the mean of the global batch's gradient, the
    one-process run's."""
    ckpt = {name: restore_checkpoint(os.path.join(d, "checkpoints"), 3)
            for name, d in (("one", runs["one"]["logdir"]), ("two", runs["two"]))}
    assert ckpt["one"]["micro_step"] == ckpt["two"]["micro_step"] == 1
    want = ckpt["one"]["accumulated_grad"].numpy()
    got = ckpt["two"]["accumulated_grad"].numpy()
    assert np.abs(want).max() > 0
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def test_two_process_resume_reaches_the_requested_step(runs):
    two = runs["two"]
    ckpts = sorted(os.listdir(os.path.join(two, "checkpoints")))
    assert ckpts == ["step_3", "step_4", "step_6"]
    assert latest_step(os.path.join(two, "checkpoints")) == RESUME_STEPS
    losses = [float(r["loss"]) for r in _rows(two)]
    assert all(np.isfinite(losses))


def test_only_the_data_axis_is_ported(tmp_path):
    """Named when the mesh flags raised; the fsdp and tensor axes are now
    ported (tests/test_torch_mesh.py), and this holds the refusals of a mesh
    the processes cannot form, beside the process-group basics."""
    with pytest.raises(ValueError, match="--num_processes 1 does not divide"):
        train.main(["--device", "cpu", "-b", TINY_CONFIG, "-l", str(tmp_path),
                    "--mesh_fsdp", "2"])
    with pytest.raises(ValueError, match="--mesh_tensor 2"):
        distributed.check_mesh(1, 1, 2)
    with pytest.raises(ValueError, match="--num_processes 3"):
        distributed.check_mesh(3, 2, 1)
    distributed.check_mesh(4, 2, 2)
    with pytest.raises(ValueError, match="needs --coordinator"):
        distributed.initialize("", 2, 0, torch.device("cpu"))
    assert not distributed.initialize("", 1, 0, torch.device("cpu"))
    assert distributed.process_count() == 1 and distributed.is_main()
    assert distributed.broadcast_str("run") == "run"
    t = torch.ones(3)
    assert distributed.all_reduce_mean(t) is t and torch.equal(t, torch.ones(3))
    assert distributed.all_reduce_mean(t, None) is t and torch.equal(t, torch.ones(3))

"""Sharded sampling (gcd_tpu_torch/engine/serving.py, parallel/frames.py,
the GroupNorm statistics over a frame group in ops/fused_norm.py, and the
mesh flags of the inference entries) on the CPU.

* Unit cases: the row rule with its replicated and refused cases; the
  re-layouts (frames_to_rows / rows_to_frames) with the all-to-all played
  by hand among the ranks' packs, against their single-process models
  (`position_block`, the frames' rows), for channels-first and
  channels-last images, tokens and a plane that F does not divide by rows;
  the GroupNorm of position blocks with their statistics summed against
  the GroupNorm of the whole tensor.
* The sampler in gloo process groups (one PyTorch intra-op thread each) on
  configs/smoke_kubric_tiny.yaml with T = 4 frames of 32x48 (4x6 latents,
  2x3 at the UNet's second level), 2 steps, fp32, JAX's seeded weights and
  JAX's latent noise: two processes at data 2 (V = 2, F = 1), four at
  data 2 x fsdp 2 (V = 2, F = 2: every temporal layer crosses processes),
  four at fsdp 2 x tensor 2 (V = 2, F = 1, the UNet cut). Each clip is held
  within 2e-5 relative L2 of the port's one-process sample_video (the same
  fp32 sums in another order) and within 1e-3 of JAX's
  gcd_tpu.engine.serving.make_sharded_sampler on the virtual CPU mesh of
  the same shape (the port's bound against JAX, tests/test_torch_slice.py),
  and every process's outputs are equal bit for bit. 2e-5 is twice the
  tiny engine's own fp32 floor: the one-process sample_video with each
  video's rows evaluated on their own (the same sums, another gemm
  blocking) differs from the whole-batch one by 9.4e-6 on the latents
  (1.1e-5 at data 2 x fsdp 2, 5.2e-6 at fsdp 2 x tensor 2). The data 2 run
  is held to that per-video run bit for bit: the row rule's single-process
  model at F = 1.
* The port's placement departs from JAX's, and these bounds are what shows
  the numbers are the same: the port splits each UNet call's CFG-doubled
  batch by videos first, then by frame blocks (JAX splits the undoubled
  clip batch over data x fsdp); it keeps the weights whole over fsdp under
  tensor > 1 (JAX's make_sampler shards them); the conditioner and the
  decode run whole on every process.
* One process in a gloo group of one: bit-identical to sample_video.
* A churned Heun sampler at data 2: its per-step noise broadcast once from
  process 0, its correction evaluations through the same row split; bit
  for bit the one-process sample_video with that noise and each video's
  rows evaluated on their own, as the data 2 Euler run is. (Against the
  whole-batch one-process run it differs by 2.6e-5: the correction to
  sigma 0.002 divides the evaluation's fp32 differences by 0.002.)
* guidance_interval at data 2 x fsdp 2: the guided step splits frames
  (F = 2), the plain step's one video takes F = 4, whose blocks do not
  split the 2x3 plane, so it runs whole on each rank (replicated).
* The infer entry with --device cpu in two gloo processes at data 2:
  process 0 alone writes, its frames those of the one-process entry; a mesh
  whose size is not --num_processes is refused naming both.
"""

import copy
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.engine.serving import make_sharded_sampler as j_make_sharded_sampler
from gcd_tpu.parallel.mesh import create_mesh as j_create_mesh
from gcd_tpu.parallel.mesh import make_param_shardings
from gcd_tpu.utils.config import instantiate_from_config as j_instantiate
from gcd_tpu_torch import infer
from gcd_tpu_torch.data.png import write_png
from gcd_tpu_torch.engine.build import engine_from_config
from gcd_tpu_torch.ops.fused_norm import (
    group_norm_from_sums_plain,
    group_norm_plain,
    group_stats_plain,
)
from gcd_tpu_torch.parallel.frames import (
    pack_frames,
    pack_rows,
    position_block,
    sample_rows,
    split_plane,
    unpack_frames,
    unpack_rows,
)
from gcd_tpu_torch.utils.config import instantiate_from_config, load_config
from tests.test_torch_distributed import _free_port
from tests.torch_port_helpers import (
    REPO,
    TINY_CONFIG,
    engine_params,
    engine_state_dict,
    rel_l2,
    tiny_batch,
)

T, H, W, STEPS = 4, 32, 48, 2
KEY = 3
# (data, fsdp, tensor) of each gloo run.
MESHES = {"data2": (2, 1, 1), "data2_fsdp2": (2, 2, 1), "fsdp2_tensor2": (1, 2, 2)}
# Of the 2-step ladder (700, 0.002), only the first step is guided.
INTERVAL = (1.0, 1000.0)
# Churn at both steps, a correction at the first: 3 evaluations, noise at 2.
HEUN = {"target": "sgm.modules.diffusionmodules.sampling.HeunEDMSampler",
        "params": {"s_churn": 1.0, "num_steps": STEPS,
                   "discretization_config": {
                       "target": "sgm.modules.diffusionmodules.discretizer.EDMDiscretization",
                       "params": {"sigma_max": 700.0}},
                   "guider_config": {
                       "target": "sgm.modules.diffusionmodules.guiders.LinearPredictionGuider",
                       "params": {"num_frames": T, "max_scale": 2.5, "min_scale": 1.0}}}}
PORT_TOL, JAX_TOL = 2e-5, 1e-3
OUTPUTS = ("sampled_video", "sampled_z", "cond_video")

# One process of a gloo run: the engine from the fixture's setup, the
# sharded sampler on the setup's batch and noise; a run of one process also
# samples the unsharded path in the same process.
CHILD = r"""
import json, sys
import torch
torch.set_num_threads(1)
from gcd_tpu_torch.engine.build import engine_from_config
from gcd_tpu_torch.engine.serving import make_sharded_sampler
from gcd_tpu_torch.parallel import distributed
from gcd_tpu_torch.parallel.mesh import create_mesh
from gcd_tpu_torch.utils.config import instantiate_from_config
work, name, mesh, interval, sampler, port, nproc, pid = sys.argv[1:]
nproc, pid = int(nproc), int(pid)
setup = torch.load(f"{work}/setup.pt")
engine = engine_from_config(setup["config"], "cpu", torch.float32, setup["state_dict"])
if interval:
    engine.sampler.guidance_interval = tuple(json.loads(interval))
step_noise = None
if sampler:
    engine.sampler = instantiate_from_config(json.loads(sampler))
    step_noise = setup["step_noise"] if pid == 0 else torch.zeros_like(setup["step_noise"])
distributed.initialize(f"127.0.0.1:{port}", nproc, pid, torch.device("cpu"))
out = {}
if nproc == 1:
    one = engine.sample_video(setup["batch"], noise=setup["noise"], num_steps=setup["steps"],
                              return_latents=True)
    out.update({"one_" + k: v for k, v in one.items()})
sample = make_sharded_sampler(engine, create_mesh(*json.loads(mesh), "cpu"),
                              num_steps=setup["steps"], return_latents=True, verbose=pid == 0)
out.update(sample(setup["batch"], setup["noise"], step_noise))
torch.save(out, f"{work}/{name}_{pid}.pt")
distributed.shutdown()
"""
ENTRY = "import sys; from gcd_tpu_torch import infer; infer.main(sys.argv[1:])"


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONSTARTUP", None)
    return env


def _launch(argv, nproc):
    """`nproc` processes of `python -c *argv(pid, port)`, one gloo group."""
    port = _free_port()
    return [subprocess.Popen([sys.executable, "-c", *argv(pid, port)], cwd=REPO, env=_env(),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(nproc)]


def _sampler_run(work, name, mesh, interval=None, sampler=None):
    nproc = int(np.prod(mesh))
    return _launch(lambda pid, port: [CHILD, work, name, json.dumps(mesh),
                                      json.dumps(interval) if interval else "",
                                      json.dumps(sampler) if sampler else "", str(port),
                                      str(nproc), str(pid)], nproc)


def _wait(procs):
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            proc.kill()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-4000:]
    return outs


def _jax_sample(jeng, params, batch, mesh_shape):
    """JAX's make_sharded_sampler on the virtual CPU mesh of `mesh_shape`,
    the weights placed as scripts/eval_utils.py's make_sampler places them."""
    data, fsdp, tensor = mesh_shape
    mesh = j_create_mesh(data, fsdp, tensor, devices=jax.devices()[:data * fsdp * tensor])
    shardings = make_param_shardings(params, mesh) if tensor > 1 else None
    sample = j_make_sharded_sampler(jeng, mesh, num_steps=STEPS, param_shardings=shardings,
                                    return_latents=True)
    out = sample(params, batch, jax.random.PRNGKey(KEY))
    return {k: np.asarray(v) for k, v in out.items()}


def _per_video(engine):
    """engine.denoise with each video's rows evaluated on their own, in one
    process: the row rule at F = 1 without a process group."""
    def denoise(x, sigma, cond, ioi):
        return torch.cat([engine.denoise(x[i * T:(i + 1) * T], sigma[i * T:(i + 1) * T],
                                         {k: v[i * T:(i + 1) * T] for k, v in cond.items()},
                                         ioi[i:i + 1])
                          for i in range(x.shape[0] // T)])

    return denoise


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo runs (started first, they run beside the rest), the port's
    one-process clips and JAX's sharded ones, the infer entry's runs."""
    work = str(tmp_path_factory.mktemp("sharded"))
    cfg = load_config(TINY_CONFIG)["model"]
    cfg["params"]["sampler_config"]["params"]["guider_config"]["params"]["num_frames"] = T
    batch = tiny_batch(T, H, W, 8)
    jeng = j_instantiate(copy.deepcopy(cfg))
    params = engine_params(jeng, batch, 20)
    emb_models = cfg["params"]["conditioner_config"]["params"]["emb_models"]
    noise = np.array(jax.random.normal(jax.random.split(jax.random.PRNGKey(KEY))[0],
                                       (T, H // 8, W // 8, 4), dtype=jnp.float32))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    step_noise = torch.randn((STEPS, T, 4, H // 8, W // 8),
                             generator=torch.Generator().manual_seed(5))
    torch.save({"config": cfg, "state_dict": engine_state_dict(params, emb_models, 30),
                "batch": tbatch, "noise": torch.from_numpy(noise), "steps": STEPS,
                "step_noise": step_noise}, os.path.join(work, "setup.pt"))

    inputs = os.path.join(work, "inputs")
    os.makedirs(inputs)
    write_png(os.path.join(inputs, "still.png"),
              np.random.default_rng(0).integers(0, 256, (40, 60, 3), dtype=np.uint8))
    entry_args = ["--device", "cpu", "--config_path", TINY_CONFIG, "--input", inputs,
                  "--num_frames", str(T), "--input_frames", str(T), "--frame_width", str(W),
                  "--frame_height", str(H), "--num_steps", str(STEPS), "--decoding_t", "2",
                  "--num_samples", "1"]

    procs = {name: _sampler_run(work, name, mesh) for name, mesh in MESHES.items()}
    procs["interval"] = _sampler_run(work, "interval", MESHES["data2_fsdp2"], INTERVAL)
    procs["one_rank"] = _sampler_run(work, "one_rank", (1, 1, 1))
    procs["heun"] = _sampler_run(work, "heun", MESHES["data2"], sampler=HEUN)
    procs["entry"] = _launch(lambda pid, port: [
        ENTRY, *entry_args, "--output", os.path.join(work, f"entry_{pid}"), "--mesh_data", "2",
        "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2", "--process_id",
        str(pid)], 2)

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pool = ThreadPoolExecutor(len(MESHES))  # JAX compiles beside the port's runs
    jax_jobs = {name: pool.submit(_jax_sample, jeng, params, jbatch, mesh)
                for name, mesh in MESHES.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        engine = engine_from_config(cfg, "cpu", torch.float32,
                                    engine_state_dict(params, emb_models, 30))
        one = engine.sample_video(tbatch, noise=torch.from_numpy(noise), num_steps=STEPS,
                                  return_latents=True)
        per_video = engine.sample_video(tbatch, noise=torch.from_numpy(noise), num_steps=STEPS,
                                        return_latents=True, denoise=_per_video(engine))
        engine.sampler.guidance_interval = INTERVAL
        assert engine.sampler.guided_steps(STEPS) == [True, False]
        one_interval = engine.sample_video(tbatch, noise=torch.from_numpy(noise),
                                           num_steps=STEPS, return_latents=True)
        engine.sampler = instantiate_from_config(HEUN)
        one_heun = engine.sample_video(tbatch, noise=torch.from_numpy(noise), num_steps=STEPS,
                                       return_latents=True, step_noise=step_noise,
                                       denoise=_per_video(engine))
        entry_one = os.path.join(work, "entry_one")
        infer.main([*entry_args, "--output", entry_one])
    finally:
        torch.set_num_threads(threads)
        jax_out = {name: job.result() for name, job in jax_jobs.items()}
        pool.shutdown()
    logs = {name: _wait(p) for name, p in procs.items()}
    got = {name: [torch.load(os.path.join(work, f"{name}_{pid}.pt")) for pid in range(len(p))]
           for name, p in procs.items() if name != "entry"}
    return dict(work=work, one=one, per_video=per_video, one_interval=one_interval,
                one_heun=one_heun, jax=jax_out, got=got, logs=logs, entry_one=entry_one)


# ---- unit cases -----------------------------------------------------------


def test_row_rule():
    # One clip on 2 cards: cond and uncond each on their own card.
    assert [(p.video_start, p.video_stop, p.frame_start, p.frame_stop)
            for p in (sample_rows(2, 2, 14, r) for r in range(2))] == [(0, 1, 0, 14),
                                                                      (1, 2, 0, 14)]
    # One clip on 4 cards: V = 2, F = 2, 7 frames a rank.
    plans = [sample_rows(4, 2, 14, r, (1536, 384, 96, 24)) for r in range(4)]
    assert {(p.blocks, p.frame_blocks) for p in plans} == {(2, 2)}
    assert [(p.video_block, p.frame_start, p.frame_stop) for p in plans] == [
        (0, 0, 7), (0, 7, 14), (1, 0, 7), (1, 7, 14)]
    assert all(p.frame_split for p in plans)
    # Two clips on 4 cards: V = 4, F = 1.
    assert [sample_rows(4, 4, 14, r).video_start for r in range(4)] == [0, 1, 2, 3]
    # Three clips on 4 cards: V = 2 blocks of 3 videos, F = 2.
    p = sample_rows(4, 6, 14, 3)
    assert (p.video_start, p.video_stop, p.frame_start, p.frame_stop) == (3, 6, 7, 14)
    # Replicated: F does not divide T (one clip on 8 ranks: F = 4), or a plane.
    for plan in (sample_rows(8, 2, 14, 5), sample_rows(4, 1, 4, 2, (24, 6))):
        assert plan.replicated and not plan.frame_split
        assert (plan.frame_start, plan.frame_stop) == (0, plan.frame_stop) and \
            plan.frame_stop in (14, 4)
    assert sample_rows(8, 2, 14, 5).video_block == 1
    # One rank: everything.
    p = sample_rows(1, 2, 14, 0)
    assert (p.blocks, p.frame_blocks, p.video_stop, p.frame_stop) == (1, 1, 2, 14)
    for bad in ((0, 2, 14, 0), (2, 0, 14, 0), (2, 2, 0, 0), (2, 2, 14, 2), (2, 2, 14, -1)):
        with pytest.raises(ValueError):
            sample_rows(*bad)


def _exchange_by_hand(packs):
    """What all_to_all_single leaves on each rank: block i of rank j's
    receive buffer is block j of rank i's send buffer."""
    return [torch.stack([pack[j] for pack in packs]) for j in range(len(packs))]


@pytest.mark.parametrize("layout,size,hw", [("contiguous", 2, (4, 6)),
                                            ("channels_last", 2, (4, 6)),
                                            ("channels_last", 4, (2, 6)),
                                            ("contiguous", 4, (2, 6)),
                                            ("tokens", 2, (4, 6))])
def test_relayouts_match_their_models(layout, size, hw):
    videos, c = 2, 8
    gen = torch.Generator().manual_seed(1)
    whole = torch.randn(videos * T, c, *hw, generator=gen)
    if layout == "tokens":
        whole = whole.flatten(2).transpose(1, 2).contiguous()  # (N, S, C)
    elif layout == "channels_last":
        whole = whole.contiguous(memory_format=torch.channels_last)
    local = T // size
    frames = [whole.reshape(videos, T, *whole.shape[1:])[:, i * local:(i + 1) * local]
              .reshape(videos * local, *whole.shape[1:]) for i in range(size)]
    if layout == "channels_last":
        frames = [f.contiguous(memory_format=torch.channels_last) for f in frames]
    recv = _exchange_by_hand([pack_frames(f, T, size) for f in frames])
    rows = [unpack_rows(r, f, T, size) for r, f in zip(recv, frames)]
    for j, r in enumerate(rows):
        want = position_block(whole, size, j)
        assert r.shape == want.shape and torch.equal(r, want)
        if layout == "channels_last":
            assert r.is_contiguous(memory_format=torch.channels_last)
    back = _exchange_by_hand([pack_rows(r, T, size) for r in rows])
    for i, (b, f) in enumerate(zip(back, frames)):
        got = unpack_frames(b, rows[i], size, hw)
        assert got.shape == f.shape and torch.equal(got, f)
    if layout != "tokens":
        assert rows[0].shape[2:] == split_plane(hw, size)


def test_split_plane():
    assert split_plane((32, 48), 2) == (16, 48)
    assert split_plane((4, 6), 2) == (2, 6)
    assert split_plane((2, 6), 4) == (1, 3)
    with pytest.raises(ValueError, match="do not split"):
        split_plane((2, 3), 4)


@pytest.mark.parametrize("size", [2, 4])
def test_summed_statistics_give_the_whole_groupnorm(size):
    """A time_stack GroupNorm's input (B, C, T, H, W) cut into `size`
    position blocks: each block's (sum x, sum x^2) summed over the blocks
    are the whole tensor's, and each block normalised with them is that
    block of the whole GroupNorm."""
    gen = torch.Generator().manual_seed(2)
    b, c, hw = 2, 64, (4, 6)
    x = torch.randn(b, c, T, *hw, generator=gen) * 3.0 + 1.0
    weight, bias = torch.randn(c, generator=gen), torch.randn(c, generator=gen)
    whole = group_norm_plain(x, weight, bias, 32, 1e-5, True)
    blocks = [position_block(x.transpose(1, 2).reshape(b * T, c, *hw), size, j)
              for j in range(size)]
    blocks = [blk.reshape(b, T, c, *blk.shape[2:]).transpose(1, 2) for blk in blocks]
    sums = [group_stats_plain(blk, 32) for blk in blocks]
    s1, s2 = sum(s[0] for s in sums), sum(s[1] for s in sums)
    w1, w2 = group_stats_plain(x, 32)
    torch.testing.assert_close(s1, w1, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(s2, w2, rtol=1e-6, atol=1e-3)
    count = x[0].numel() // 32
    for j, blk in enumerate(blocks):
        got = group_norm_from_sums_plain(blk, weight, bias, 32, 1e-5, True, s1, s2, count)
        want = position_block(whole.transpose(1, 2).reshape(b * T, c, *hw), size, j)
        want = want.reshape(b, T, c, *want.shape[2:]).transpose(1, 2)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---- gloo runs ------------------------------------------------------------


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_matches_one_process_and_jax(runs, name):
    outs = runs["got"][name]
    assert len(outs) == int(np.prod(MESHES[name]))
    for out in outs[1:]:  # every process holds the same clip, bit for bit
        for k in OUTPUTS:
            assert torch.equal(out[k], outs[0][k]), k
    jax_out = runs["jax"][name]
    assert np.asarray(jax_out["sampled_video"]).std() > 1e-2
    for k in OUTPUTS:
        got = outs[0][k].numpy()
        assert got.shape == runs["one"][k].shape == jax_out[k].shape
        assert rel_l2(got, runs["one"][k].numpy()) <= PORT_TOL, k
        assert rel_l2(got, jax_out[k]) <= JAX_TOL, k


def test_data_axis_is_the_per_video_run_bit_for_bit(runs):
    (out, _) = runs["got"]["data2"]
    for k in OUTPUTS:
        assert torch.equal(out[k], runs["per_video"][k]), k


def test_frame_split_is_what_ran(runs):
    """Process 0 of each run prints the row rule of the batches it saw."""
    logs = runs["logs"]
    assert "V=2 video blocks x F=2 frame blocks, 1 videos x 2 frames a rank" in \
        logs["data2_fsdp2"][0]
    assert "V=2 video blocks x F=1 frame blocks, 1 videos x 4 frames a rank" in logs["data2"][0]
    assert "V=2 video blocks x F=1" in logs["fsdp2_tensor2"][0]
    assert "each video block runs whole on its 4 ranks" in logs["interval"][0]


def test_one_rank_is_sample_video_bit_for_bit(runs):
    (out,) = runs["got"]["one_rank"]
    for k in OUTPUTS:
        assert torch.equal(out[k], out["one_" + k]), k


def test_guidance_interval_matches_one_process(runs):
    outs = runs["got"]["interval"]
    for out in outs[1:]:
        for k in OUTPUTS:
            assert torch.equal(out[k], outs[0][k]), k
    for k in OUTPUTS:
        assert rel_l2(outs[0][k].numpy(), runs["one_interval"][k].numpy()) <= PORT_TOL, k
    # Guidance changes the clip: the interval run is not the full-CFG one.
    assert rel_l2(outs[0]["sampled_z"].numpy(), runs["one"]["sampled_z"].numpy()) > 1e-3


def test_churned_heun_is_the_per_video_run_bit_for_bit(runs):
    """Process 1 passes zeros as its step noise: process 0's, broadcast,
    is what both processes sample with."""
    outs = runs["got"]["heun"]
    for k in OUTPUTS:
        assert torch.equal(outs[1][k], outs[0][k]), k
        assert torch.equal(outs[0][k], runs["one_heun"][k]), k
    assert rel_l2(outs[0]["sampled_z"].numpy(), runs["one"]["sampled_z"].numpy()) > 1e-3


def test_infer_entry_in_two_processes_writes_on_process_0(runs):
    work = runs["work"]
    assert not os.path.exists(os.path.join(work, "entry_1"))
    names = sorted(os.listdir(os.path.join(work, "entry_0")))
    assert names == sorted(os.listdir(runs["entry_one"]))
    for name in names:
        if name.endswith(".npz"):
            with np.load(os.path.join(work, "entry_0", name)) as a, \
                    np.load(os.path.join(runs["entry_one"], name)) as b:
                assert a["frames"].shape == b["frames"].shape
                diff = np.abs(a["frames"].astype(int) - b["frames"].astype(int))
                assert diff.max() <= 1, name  # uint8 rounding of fp32 differences
    assert "Sampling over Mesh" in runs["logs"]["entry"][0]


def test_entry_refuses_a_mesh_that_is_not_the_process_count(tmp_path):
    args = ["--device", "cpu", "--config_path", TINY_CONFIG, "--input", str(tmp_path)]
    with pytest.raises(ValueError, match="2 processes, but --num_processes is 1"):
        infer.main([*args, "--mesh_data", "2"])
    with pytest.raises(ValueError, match="= 4 processes, but --num_processes is 2"):
        infer.main([*args, "--mesh_fsdp", "2", "--mesh_tensor", "2", "--num_processes", "2",
                    "--coordinator", "127.0.0.1:1"])

"""Sharded serving (gcd_tpu_torch/engine/server.py across processes, the split
conditioner, decode and fsdp-sharded weights of engine/serving.py, and
serve.py's mesh flags) on the CPU.

The engine is configs/smoke_kubric_tiny.yaml at T = 4 frames of 32x48, 2
steps, fp32, with JAX's seeded weights, in gloo groups of one PyTorch
intra-op thread a process:
* the mesh server at data 2 (two processes) and at fsdp 2 x tensor 2 (four
  processes; JAX's min_weight_size lowered so that the tiny UNet has leaves
  to shard), process 0 a SamplerServer(max_batch=2), the others `follow`:
  four requests in two batches, each within 2e-5 relative L2 of the
  one-process port server with the same seeds (test_torch_sharded_sampling.py's bound, twice the
  tiny engine's fp32 floor), every process's outputs equal bit for bit, the
  counters right, a bad request answered with its error before any
  collective (the followers see only the batches that pass the check), a
  batch that fails on a follower alone after its collectives failing its
  requests (logged there) while the mesh serves on, every follower exiting 0 after stop();
* the packed batch of requests 0 and 1, with the noise JAX's SamplerServer
  draws from its folded key, through the port's mesh sampler against JAX's
  SamplerServer over make_sharded_sampler (tests/test_server_sharded.py's
  composition) on the virtual CPU mesh of data 2, within 1e-3; request 0
  at fsdp 2 x tensor 2 against JAX's eval_utils.make_sampler(mesh_fsdp=2,
  mesh_tensor=2), within 1e-3, with a process's UNet state bytes below the
  replicated run's and its shards in the engine's dtype;
* the split decode at a decoding_t of more chunks than ranks (8 over 4) and
  of fewer (2 over 4), and the split conditioner at 6 and 2 videos over 4
  ranks: within 2e-5 of whole and equal bit for bit across processes;
* `python -m gcd_tpu_torch.serve` in two gloo processes with --device cpu
  at --mesh_data 2: HTTP on process 0 only, a bad request answered 500, one
  round trip, a clean stop (SIGINT to process 0, every process exits 0).
"""

import copy
import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.engine.server import SamplerServer as JSamplerServer
from gcd_tpu.engine.serving import make_sharded_sampler as j_make_sharded_sampler
from gcd_tpu.parallel.mesh import create_mesh as j_create_mesh
from gcd_tpu.utils.config import instantiate_from_config as j_instantiate
from gcd_tpu_torch.engine.build import engine_from_config
from gcd_tpu_torch.engine.server import SamplerServer, make_engine_sample_fn
from gcd_tpu_torch.engine.serving import block_items
from gcd_tpu_torch.utils.config import load_config
from scripts import eval_utils as j_eval_utils
from tests.test_torch_distributed import _free_port
from tests.torch_port_helpers import (
    REPO,
    TINY_CONFIG,
    engine_params,
    engine_state_dict,
    rel_l2,
    tiny_batch,
)

T, H, W, STEPS, MAX_BATCH = 4, 32, 48, 2, 2
SEEDS = [100, 101, 102, 103]
MESHES = {"data2": (2, 1, 1), "fsdp2_tensor2": (1, 2, 2)}
MIN_WEIGHT = 2 ** 12
PORT_TOL, JAX_TOL = 2e-5, 1e-3

# One process of a mesh server: process 0 serves the setup's requests (a bad
# one first), the others follow; then every process runs the mesh sampler
# on the packed batch with JAX's noise (and on request 0 alone at
# fsdp 2 x tensor 2), and, on four processes, the split decode and
# conditioner over a data-4 mesh.
CHILD = r"""
import json, sys
import torch
torch.set_num_threads(1)
import gcd_tpu_torch.parallel.mesh as mesh_rules
from torch.distributed.tensor import DTensor
from gcd_tpu_torch.engine.build import engine_from_config
from gcd_tpu_torch.engine.engine import UC_ZERO_KEYS
from gcd_tpu_torch.engine.server import (SamplerServer, batch_check, follow,
                                         make_engine_sample_fn, sample_keys)
from gcd_tpu_torch.engine.serving import make_sharded_sampler, split_conditioner, split_decode
from gcd_tpu_torch.parallel import distributed
from gcd_tpu_torch.parallel.mesh import create_mesh
work, name, shape, port, nproc, pid = sys.argv[1:]
nproc, pid, shape = int(nproc), int(pid), json.loads(shape)
mesh_rules.MIN_WEIGHT_SIZE = %d
setup = torch.load(f"{work}/setup.pt", weights_only=False)
engine = engine_from_config(setup["config"], "cpu", torch.float32,
                            setup["state_dict"]).requires_grad_(False)
cpu = torch.device("cpu")
distributed.initialize(f"127.0.0.1:{port}", nproc, pid, cpu)
mesh = create_mesh(*shape, "cpu")
fn = make_engine_sample_fn(engine, 2, setup["T"], num_steps=setup["steps"], mesh=mesh)
unet = engine.model.diffusion_model
local = [p.to_local() if isinstance(p, DTensor) else p for p in unet.parameters()]
out = {"unet_bytes": sum(p.numel() * p.element_size() for p in local),
       "sharded": sum(isinstance(p, DTensor) for p in unet.parameters()),
       "dtypes": sorted({str(p.dtype) for p in local})}
if pid == 0:
    srv = SamplerServer(fn, setup["T"], max_batch=2, max_wait_ms=3000.0,
                        check=batch_check(sample_keys(engine), 2, setup["T"]),
                        mesh_device=cpu).start()
    try:
        for what, req, seed in (("bad", setup["bad"], 1), ("fault", setup["requests"][0], 999)):
            try:
                srv.submit(req, seed=seed).result(timeout=300)
                out[what] = None
            except Exception as e:
                out[what] = f"{type(e).__name__}: {e}"
        res = []
        for pair in ((0, 1), (2, 3)):
            futs = [srv.submit(setup["requests"][i], seed=setup["seeds"][i]) for i in pair]
            res += [f.result(timeout=300) for f in futs]
    finally:
        srv.stop()
    out.update(results=res, batches_run=srv.batches_run, requests_served=srv.requests_served)
else:
    seen = []
    def recording(batch, seeds):
        out = fn(batch, seeds)
        if 999 in seeds:  # a fault on this process alone, after the batch's collectives
            raise RuntimeError("a follower's fault")
        seen.append(out)
        return out
    out["followed"] = follow(recording, cpu)
    out["batches"] = seen
sampler = make_sharded_sampler(engine, mesh, num_steps=setup["steps"])
out["jax_pair"] = sampler(setup["pair"], setup["pair_noise"])
if shape == [1, 2, 2]:
    # JAX's make_sampler samples the config's steps (4).
    one = make_sharded_sampler(engine, mesh, decoding_t=setup["T"])
    out["jax_one"] = one(setup["one"], setup["one_noise"])
    mesh4 = create_mesh(4, 1, 1, "cpu")
    z = setup["z"]
    for dt in (1, 4):
        out[f"decode_{dt}"] = split_decode(engine, mesh4, dt)(z)
        out[f"decode_{dt}_whole"] = engine.decode_first_stage(z, dt)
    for videos, batch in setup["cond_batches"].items():
        out[f"cond_{videos}"] = split_conditioner(engine, mesh4)(batch)
        out[f"cond_{videos}_whole"] = engine.get_unconditional_conditioning(batch, UC_ZERO_KEYS)
torch.save(out, f"{work}/{name}_{pid}.pt")
distributed.shutdown()
""" % MIN_WEIGHT


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONSTARTUP", None)
    return env


def _launch(argv, nproc):
    """`nproc` processes of `python *argv(pid, port)`, one gloo group."""
    port = _free_port()
    return [subprocess.Popen([sys.executable, *argv(pid, port)], cwd=REPO, env=_env(),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(nproc)]


def _wait(procs, timeout=300):
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            proc.kill()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-4000:]
    return outs


def _request(seed):
    """One clip's request arrays, as a client builds them (construct_batch's keys)."""
    return {k: v for k, v in tiny_batch(T, H, W, seed).items()}


def _post(url, arrays, timeout=300):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = np.load(io.BytesIO(resp.read()))
        return {k: out[k] for k in out.files}


def _serve_run(work, http_port):
    args = ["-m", "gcd_tpu_torch.serve", "--device", "cpu", "--config_path", TINY_CONFIG,
            "--num_frames", str(T), "--frame_width", str(W), "--frame_height", str(H),
            "--num_steps", str(STEPS), "--max_batch", str(MAX_BATCH), "--port",
            str(http_port), "--mesh_data", "2", "--num_processes", "2"]
    return _launch(lambda pid, port: [*args, "--coordinator", f"127.0.0.1:{port}",
                                      "--process_id", str(pid)], 2)


def _jax_noise(key, rows):
    return np.array(jax.random.normal(jax.random.split(key)[0], (rows, H // 8, W // 8, 4),
                                      dtype=jnp.float32))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo runs (started first, they run beside the rest), JAX's
    server and make_sampler, and the port's one-process server."""
    work = str(tmp_path_factory.mktemp("sharded_serving"))
    cfg = load_config(TINY_CONFIG)["model"]
    cfg["params"]["sampler_config"]["params"]["guider_config"]["params"]["num_frames"] = T
    requests = [_request(20 + i) for i in range(4)]
    jeng = j_instantiate(copy.deepcopy(cfg))
    params = engine_params(jeng, requests[0], 20)
    emb_models = cfg["params"]["conditioner_config"]["params"]["emb_models"]
    state_dict = engine_state_dict(params, emb_models, 30)

    # JAX's SamplerServer folds the keys of a batch's requests into one.
    pair = {k: np.concatenate([requests[0][k], requests[1][k]]) for k in requests[0]}
    pair_key = jax.random.fold_in(jax.random.PRNGKey(SEEDS[0]), SEEDS[1])
    one_key = jax.random.PRNGKey(7)
    gen = torch.Generator().manual_seed(5)
    z = torch.randn(2 * T, 4, H // 8, W // 8, generator=gen)
    cond_batches = {v: _torch_batch({k: np.concatenate([_request(40 + i)[k] for i in range(v)])
                                     for k in requests[0]}) for v in (2, 6)}
    bad = dict(requests[0])
    del bad["fps_id"]
    torch.save({"config": cfg, "state_dict": state_dict, "T": T, "steps": STEPS,
                "requests": requests, "seeds": SEEDS, "bad": bad,
                "pair": _torch_batch(pair), "pair_noise": torch.from_numpy(_jax_noise(
                    pair_key, 2 * T)),
                "one": _torch_batch(requests[0]),
                "one_noise": torch.from_numpy(_jax_noise(one_key, T)), "z": z,
                "cond_batches": cond_batches}, os.path.join(work, "setup.pt"))

    procs = {name: _launch(lambda pid, port, name=name, shape=shape: [
        "-c", CHILD, work, name, json.dumps(shape), str(port), str(int(np.prod(shape))),
        str(pid)], int(np.prod(shape))) for name, shape in MESHES.items()}
    http_port = _free_port()
    serve_procs = _serve_run(work, http_port)

    def jax_server():
        mesh = j_create_mesh(data=2, devices=jax.devices()[:2])
        sharded = j_make_sharded_sampler(jeng, mesh, num_steps=STEPS)
        srv = JSamplerServer(lambda b, k: sharded(params, b, k), T, max_batch=MAX_BATCH,
                             max_wait_ms=5000).start()
        try:
            futs = [srv.submit({k: jnp.asarray(v) for k, v in requests[i].items()},
                               jax.random.PRNGKey(SEEDS[i])) for i in (0, 1)]
            return [f.result(timeout=600) for f in futs]
        finally:
            srv.stop()

    def jax_make_sampler():
        class Bundle:
            pass

        b = Bundle()
        b.engine, b.params = jeng, params
        sample = j_eval_utils.make_sampler(b, mesh_data=1, mesh_fsdp=2, mesh_tensor=2,
                                           decoding_t=T)
        out = sample({k: jnp.asarray(v) for k, v in requests[0].items()}, one_key)
        return {k: np.asarray(v) for k, v in out.items()}

    pool = ThreadPoolExecutor(2)  # JAX compiles beside the port's runs
    jax_jobs = {"server": pool.submit(jax_server), "make_sampler": pool.submit(jax_make_sampler)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        engine = engine_from_config(cfg, "cpu", torch.float32,
                                    state_dict).requires_grad_(False)
        srv = SamplerServer(make_engine_sample_fn(engine, MAX_BATCH, T, num_steps=STEPS), T,
                            max_batch=MAX_BATCH, max_wait_ms=3000.0).start()
        try:
            one = []
            for i, j in ((0, 1), (2, 3)):
                futs = [srv.submit(requests[k], seed=SEEDS[k]) for k in (i, j)]
                one += [f.result(timeout=300) for f in futs]
        finally:
            srv.stop()
        serve = _serve_requests(f"http://127.0.0.1:{http_port}", requests[0], bad,
                                serve_procs[0])
    finally:
        torch.set_num_threads(threads)
        jax_out = {name: job.result() for name, job in jax_jobs.items()}
        pool.shutdown()
    serve["logs"] = _wait(serve_procs)
    logs = {name: _wait(p) for name, p in procs.items()}
    got = {name: [torch.load(os.path.join(work, f"{name}_{pid}.pt"), weights_only=False)
                  for pid in range(len(p))] for name, p in procs.items()}
    return dict(one=one, jax=jax_out, got=got, logs=logs, serve=serve)


def _serve_requests(url, request, bad, proc0, timeout=240.0):
    """Wait for serve.py's port, send a bad request and a good one, then
    SIGINT process 0."""
    t0 = time.monotonic()
    while True:
        try:
            with urllib.request.urlopen(f"{url}/healthz", timeout=5) as resp:
                health = json.loads(resp.read())
            break
        except OSError:
            if proc0.poll() is not None or time.monotonic() - t0 > timeout:
                raise RuntimeError("serve.py did not open its port")
            time.sleep(0.2)
    out = {"health": health}
    try:
        _post(f"{url}/sample", bad)
        out["bad"] = None
    except urllib.error.HTTPError as e:
        out["bad"] = (e.code, e.read().decode())
    out["good"] = _post(f"{url}/sample", dict(request, seed=np.int64(SEEDS[0])))
    proc0.send_signal(signal.SIGINT)
    return out


# ---- unit cases -----------------------------------------------------------


def test_block_items():
    assert [block_items(8, 4, r) for r in range(4)] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert [block_items(2, 4, r) for r in range(4)] == [[0], [1], [1], [1]]
    assert [block_items(5, 4, r) for r in range(4)] == [[0, 1], [2, 3], [4, 4], [4, 4]]
    assert [block_items(3, 1, 0)] == [[0, 1, 2]]


# ---- gloo runs ------------------------------------------------------------


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_server_matches_one_process_server(runs, name):
    outs = runs["got"][name]
    lead = outs[0]
    assert lead["batches_run"] == 2 and lead["requests_served"] == 4
    assert lead["bad"] is not None and "fps_id" in lead["bad"]
    # A batch that fails on a follower fails its request; the mesh goes on.
    assert lead["fault"] is not None and "failed on" in lead["fault"]
    for got, want in zip(lead["results"], runs["one"]):
        assert got["sampled_video"].shape == (T, H, W, 3)
        assert np.isfinite(got["sampled_video"]).all()
        for k in ("sampled_video", "cond_video"):
            assert rel_l2(got[k], want[k]) <= PORT_TOL, k
    assert rel_l2(lead["results"][0]["sampled_video"], lead["results"][1]["sampled_video"]) > 1e-3
    for follower in outs[1:]:  # the same batches, bit for bit; the bad one never sent
        assert follower["followed"] == 3 and len(follower["batches"]) == 2
        assert "a follower's fault" in runs["logs"][name][1]
        for b, batch in enumerate(follower["batches"]):
            for i in range(MAX_BATCH):
                np.testing.assert_array_equal(batch["sampled_video"][i * T:(i + 1) * T].numpy(),
                                              lead["results"][2 * b + i]["sampled_video"])
        assert torch.equal(follower["jax_pair"]["sampled_video"], lead["jax_pair"]["sampled_video"])


def test_mesh_sampler_matches_jax_server(runs):
    jax_outs = runs["jax"]["server"]
    for out in runs["got"]["data2"] + runs["got"]["fsdp2_tensor2"]:
        got = out["jax_pair"]["sampled_video"].numpy()
        assert np.asarray(jax_outs[0]["sampled_video"]).std() > 1e-2
        for i, want in enumerate(jax_outs):
            assert rel_l2(got[i * T:(i + 1) * T], want["sampled_video"]) <= JAX_TOL, i


def test_fsdp_tensor_mesh_shards_the_weights_and_matches_jax_make_sampler(runs):
    replicated = runs["got"]["data2"][0]
    assert replicated["sharded"] == 0
    want = runs["jax"]["make_sampler"]
    for out in runs["got"]["fsdp2_tensor2"]:
        assert out["sharded"] > 0 and out["dtypes"] == ["torch.float32"]
        assert out["unet_bytes"] < replicated["unet_bytes"]
        for k in ("sampled_video", "cond_video"):
            got = out["jax_one"][k].numpy()
            assert got.shape == want[k].shape
            assert rel_l2(got, want[k]) <= JAX_TOL, k


@pytest.mark.parametrize("what", ["decode_1", "decode_4", "cond_2", "cond_6"])
def test_split_decode_and_conditioner_match_whole(runs, what):
    outs = runs["got"]["fsdp2_tensor2"]
    first = outs[0][what]
    if what.startswith("decode"):
        assert rel_l2(first.numpy(), outs[0][what + "_whole"].numpy()) <= PORT_TOL
        assert all(torch.equal(o[what], first) for o in outs[1:])
        return
    for got, whole in zip(first, outs[0][what + "_whole"]):  # c, uc
        assert sorted(got) == sorted(whole)
        for k in whole:
            assert got[k].shape == whole[k].shape
            if whole[k].abs().max() > 0:
                assert rel_l2(got[k].numpy(), whole[k].numpy()) <= PORT_TOL, k
            for o in outs[1:]:
                assert torch.equal(o[what][0][k], first[0][k])
                assert torch.equal(o[what][1][k], first[1][k])


def test_serve_entry_in_two_processes(runs):
    serve = runs["serve"]
    logs = serve["logs"]
    assert "serving on" in logs[0] and "serving on" not in logs[1]
    assert serve["health"]["ok"] and serve["health"]["num_frames"] == T
    assert serve["bad"][0] == 500 and "fps_id" in serve["bad"][1]
    good = serve["good"]["sampled_video"]
    assert good.shape == (T, H, W, 3) and np.isfinite(good).all()

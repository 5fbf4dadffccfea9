"""The port's serving path on the CPU: the request batcher
(engine/server.py), the HTTP front end (serve.py) over the engine and over
an exported sampler (--artifact, with its refusals), the request batch a
client builds (engine/bundle.py) against scripts/eval_utils.py, and
released-checkpoint loading with the EMA overlay (io/checkpoint.py) against
gcd_tpu/io/convert.py.

The engine is the port's tiny one (configs/smoke_kubric_tiny.yaml) on the
CPU in fp32 with 2 sampling steps, 3-frame 32x48 clips, decoded a clip at a
time. A request's frames must not depend on its batch-mates: served beside
another and served alone (padded with a copy of itself) they differ only in
the order of fp32 sums, against a bound of 1e-5 relative L2.
"""

import copy
import io
import json
import struct
import threading
import types
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from gcd_tpu.io import convert as jconvert
from gcd_tpu_torch.engine.bundle import construct_batch, construct_trajectory, load_model_bundle
from gcd_tpu_torch.engine.server import SamplerServer, _concat_requests, make_engine_sample_fn
from gcd_tpu_torch.io.checkpoint import (
    checkpoint_state_dict,
    extract_ema_state_dict,
    read_safetensors,
)
from gcd_tpu_torch.ops import current_flags, kernel_flags
from gcd_tpu_torch.engine.export import export_sampler
from gcd_tpu_torch.serve import load_artifact
from gcd_tpu_torch.serve import main as serve_main
from gcd_tpu_torch.serve import make_handler
from gcd_tpu_torch.utils.config import instantiate_from_config
from scripts import eval_utils
from tests.torch_port_helpers import TINY_CONFIG, rel_l2
from tests.torch_threads import one_torch_thread  # noqa: F401

T, H, W = 3, 32, 48
TOL = 1e-5


def _clip(bundle, seed, azimuth):
    frames = np.random.default_rng(seed).uniform(size=(T, H, W, 3))
    return construct_batch(frames, azimuth, 5.0, 0.0, T, 5, 127, 0.02, False, bundle)


@pytest.fixture(scope="module")
def bundle():
    # Frozen, as serve.py freezes it: on the CPU a convolution's algorithm
    # depends on whether its weight requires grad (engine/export.py's tests).
    b = load_model_bundle(TINY_CONFIG, None, num_steps=2, num_frames=T, device="cpu",
                          dtype=torch.float32)
    b.engine.requires_grad_(False)
    return b


@pytest.fixture(scope="module")
def server(bundle):
    srv = SamplerServer(make_engine_sample_fn(bundle.engine, 2, T, decoding_t=T), T,
                        max_batch=2, max_wait_ms=500).start()
    yield srv
    srv.stop()


def test_concat_requests_pads_and_stacks():
    clips = [{"x": np.full((T, 2), i, np.float32), "num_video_frames": T} for i in range(2)]
    out = _concat_requests(clips, 3)
    assert out["num_video_frames"] == T
    np.testing.assert_array_equal(out["x"][:, 0], [0, 0, 0, 1, 1, 1, 1, 1, 1])


def test_batched_requests_match_lone_ones_and_drop_the_padding(bundle, server):
    clips = [_clip(bundle, i, 10.0 * i) for i in range(4)]
    runs = server.batches_run
    futs = [server.submit(c, seed=100 + i) for i, c in enumerate(clips)]
    outs = [f.result(timeout=120) for f in futs]
    assert server.batches_run - runs == 2
    for out in outs:
        assert out["sampled_video"].shape == (T, H, W, 3)  # the padded tail is dropped
        assert np.isfinite(out["sampled_video"]).all()
    lone = server.submit(clips[0], seed=100).result(timeout=120)  # padded partial batch
    assert server.batches_run - runs == 3
    assert rel_l2(lone["sampled_video"], outs[0]["sampled_video"]) <= TOL
    assert rel_l2(outs[0]["sampled_video"], outs[1]["sampled_video"]) > 1e-6  # not constant
    with pytest.raises(ValueError, match="does not divide"):
        make_engine_sample_fn(bundle.engine, 2, T)  # the tiny config decodes 2 frames a chunk


def test_ancestral_requests_in_one_batch_match_lone_ones(bundle):
    """Euler-ancestral draws noise at every step: each clip's from its own
    request's generator after its latent noise, so two requests batched
    together give each the frames it gets alone."""
    engine = copy.copy(bundle.engine)  # the same modules, another sampler
    engine.sampler = instantiate_from_config({
        "target": "sgm.modules.diffusionmodules.sampling.EulerAncestralSampler",
        "params": {"num_steps": 2, "discretization_config": {
            "target": "sgm.modules.diffusionmodules.discretizer.EDMDiscretization",
            "params": {"sigma_max": 700.0}}, "guider_config": {
            "target": "sgm.modules.diffusionmodules.guiders.LinearPredictionGuider",
            "params": {"num_frames": T, "max_scale": 1.5}}}})
    srv = SamplerServer(make_engine_sample_fn(engine, 2, T, decoding_t=T), T, max_batch=2,
                        max_wait_ms=500).start()
    try:
        clips = [_clip(bundle, i, 10.0 * i) for i in range(2)]
        pair = [f.result(timeout=120) for f in [srv.submit(c, seed=200 + i)
                                                for i, c in enumerate(clips)]]
        assert srv.batches_run == 1
        alone = [srv.submit(c, seed=200 + i).result(timeout=120) for i, c in enumerate(clips)]
    finally:
        srv.stop()
    for a, b in zip(alone, pair):
        assert np.isfinite(b["sampled_video"]).all()
        assert rel_l2(a["sampled_video"], b["sampled_video"]) <= TOL
    assert rel_l2(pair[0]["sampled_video"], pair[1]["sampled_video"]) > 1e-6  # not constant


def test_http_round_trip(bundle, server):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server, T))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        clip = {k: v for k, v in _clip(bundle, 7, 20.0).items() if k != "num_video_frames"}
        buf = io.BytesIO()
        np.savez(buf, seed=np.int64(3), **clip)
        req = urllib.request.Request(f"{url}/sample", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            out = np.load(io.BytesIO(resp.read()))
            assert out["sampled_video"].shape == (T, H, W, 3)
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["num_frames"] == T and health["requests_served"] >= 1
        bad = io.BytesIO()
        np.savez(bad, **{**clip, "image_only_indicator": np.zeros((1, T + 1), np.float32)})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(f"{url}/sample", data=bad.getvalue(),
                                                          method="POST"), timeout=30)
        assert err.value.code == 500
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_wrong_t_and_stop():
    release = threading.Event()

    def sample_fn(batch, seeds):
        release.wait(30)
        return {"sampled_video": np.zeros((T, 1))}

    srv = SamplerServer(sample_fn, T, max_batch=1, max_wait_ms=1).start()
    clip = {"image_only_indicator": np.zeros((1, T), np.float32)}
    with pytest.raises(ValueError, match="T=3"):
        srv.submit({"image_only_indicator": np.zeros((1, T + 1), np.float32)})
    running = srv.submit(clip, seed=0)
    while srv._queue.qsize():  # the worker holds the first request
        threading.Event().wait(0.01)
    pending = [srv.submit(clip, seed=i) for i in range(2)]
    srv.stop(timeout=0.1)
    for fut in pending:
        with pytest.raises(RuntimeError, match="stopped"):
            fut.result(timeout=5)
    with pytest.raises(RuntimeError, match="stopped"):
        srv.submit(clip)
    release.set()
    assert running.result(timeout=30)["sampled_video"].shape == (T, 1)


class _FlagRecorder(torch.nn.Module):
    """An engine stand-in that records the kernel switches it runs under."""

    def __init__(self):
        super().__init__()
        self.p = torch.nn.Parameter(torch.zeros(1))
        self.seen = []

    def sample_video(self, batch, noise=None, num_steps=None, decoding_t=None):
        self.seen.append((threading.current_thread().name, current_flags()))
        return {"sampled_video": noise}


def test_worker_thread_runs_under_the_callers_switches():
    engine = _FlagRecorder()
    with kernel_flags(fused_gn_conv=False):
        fn = make_engine_sample_fn(engine, 1, T)
    srv = SamplerServer(fn, T, max_batch=1).start()
    try:
        clip = {"image_only_indicator": np.zeros((1, T), np.float32),
                "cond_frames": np.zeros((T, 16, 16, 3), np.float32)}
        out = srv.submit(clip, seed=5).result(timeout=30)
    finally:
        srv.stop()
    (thread, flags), = engine.seen
    assert thread != threading.current_thread().name
    assert flags["fused_gn_conv"] is False and flags["flash"] is True
    want = torch.randn((T, 2, 2, 4), generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(out["sampled_video"], want.numpy())


@pytest.mark.parametrize("control", ["spherical", "relative_pose", "none"])
def test_construct_batch_matches_eval_utils(control):
    meta = dict(delta_azimuth_range=[-40.0, 60.0], delta_elevation_range=[0.0, 30.0],
                delta_radius_range=[0.0, 0.0], trajectory="interpol_sine", move_time=2,
                camera_control=control, motion_bucket_range=[10, 200])
    frames = np.random.default_rng(9).uniform(size=(4, 8, 8, 3)).astype(np.float32)
    args = (frames, 30.0, 12.0, 0.5, 3, 7, 127, 0.05, False)
    got = construct_batch(*args, types.SimpleNamespace(**meta), rng=np.random.default_rng(1))
    want = eval_utils.construct_batch(*args, types.SimpleNamespace(**meta),
                                      rng=np.random.default_rng(1))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    for traj, move in (("interpol_linear", 5), ("interpol_sine", 2)):
        start, end = np.zeros(3, np.float32), np.array([30.0, -10.0, 1.0], np.float32)
        got_t = construct_trajectory(start, end, traj, 4, move)
        want_t = eval_utils.common.construct_trajectory(start, end, traj, 4, move)
        for a, b in zip(got_t, want_t):
            np.testing.assert_array_equal(a, b)


def _write_safetensors(path, sd):
    header, blobs, offset = {}, [], 0
    for k, v in sd.items():
        raw = v.contiguous().numpy().tobytes()
        header[k] = {"dtype": "F32", "shape": list(v.shape), "data_offsets": [offset,
                                                                              offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


@pytest.mark.parametrize("fmt", ["ckpt", "safetensors"])
def test_checkpoint_with_ema_overlay(bundle, tmp_path, fmt):
    live = {k: v.detach().clone().float() for k, v in bundle.engine.state_dict().items()}
    sd = dict(live)
    unet = [k for k in live if k.startswith("model.diffusion_model.")]
    for k in unet:
        sd["model_ema." + k[len("model."):].replace(".", "")] = live[k] + 1.0
    sd["model_ema.num_updates"] = torch.tensor(7.0)
    sd["model_ema.decay"] = torch.tensor(0.999)
    path = str(tmp_path / f"tiny.{fmt}")
    if fmt == "ckpt":
        torch.save({"state_dict": sd, "global_step": 3}, path)
    else:
        _write_safetensors(path, sd)
        back = read_safetensors(path)
        assert sorted(back) == sorted(sd) and all(torch.equal(back[k], v) for k, v in sd.items())

    ema = extract_ema_state_dict(sd)
    want = jconvert.extract_ema_state_dict({k: v.numpy() for k, v in sd.items()})
    assert sorted(ema) == sorted(want) == sorted(unet)
    assert all(np.array_equal(ema[k].numpy(), want[k]) for k in want)
    assert "model.diffusion_model.input_blocks.0.0.weight" not in checkpoint_state_dict(
        path, ablate_unet_scratch=True)

    for use_ema in (False, True):
        loaded = load_model_bundle(TINY_CONFIG, path, support_ema=use_ema, num_steps=2,
                                   num_frames=T, device="cpu", dtype=torch.float32).engine
        got = loaded.state_dict()
        assert loaded.missing_keys == []
        assert sorted(loaded.unexpected_keys) == sorted(k for k in sd if k.startswith("model_ema."))
        for k in live:
            assert torch.equal(got[k], live[k] + 1.0 if use_ema and k in unet else live[k]), k


@pytest.fixture(scope="module")
def artifact(bundle, tmp_path_factory):
    """The engine exported for the served batch: two clips of the requests'
    arrays, 2 steps, a clip a decode chunk."""
    engine = bundle.engine
    pair = _concat_requests([_clip(bundle, i, 10.0 * i) for i in range(2)], 2)
    batch = {k: v if np.isscalar(v) else torch.from_numpy(np.asarray(v, np.float32))
             for k, v in pair.items()}
    path = tmp_path_factory.mktemp("artifact") / "served.gcdexp"
    path.write_bytes(export_sampler(engine, engine.state_dict(), batch, num_steps=2,
                                    decoding_t=T))
    return str(path)


def test_artifact_server_serves_the_eager_servers_frames(bundle, server, artifact):
    """The --artifact server (serve.py load_artifact: the exported sampler
    with the bundle's weights, each clip's noise from its seed) behind the
    HTTP handler, against the eager server on the same requests and seeds:
    bit for bit on the CPU."""
    fn, check = load_artifact(artifact, bundle.engine.state_dict(), 2, T, (H, W))
    srv = SamplerServer(fn, T, max_batch=2, max_wait_ms=500, check=check).start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv, T))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/sample"
    clips = [{k: v for k, v in _clip(bundle, 50 + i, 15.0 * i).items()
              if k != "num_video_frames"} for i in range(2)]
    try:
        def post(i):
            buf = io.BytesIO()
            np.savez(buf, seed=np.int64(60 + i), **clips[i])
            req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                out = np.load(io.BytesIO(resp.read()))
                return {k: out[k] for k in out.files}

        with ThreadPoolExecutor(2) as pool:
            got = list(pool.map(post, range(2)))
        bad = io.BytesIO()
        np.savez(bad, **{k: v for k, v in clips[0].items() if k != "fps_id"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(url, data=bad.getvalue(),
                                                          method="POST"), timeout=30)
        assert err.value.code == 500 and b"fps_id" in err.value.read()
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
    assert srv.batches_run == 1
    futs = [server.submit(c, seed=60 + i) for i, c in enumerate(clips)]
    want = [f.result(timeout=120) for f in futs]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and "sampled_video" in w
        for k in w:
            assert np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("extra,message", [
    (["--num_steps", "2"], "bakes them in"),
    (["--decoding_t", str(T)], "bakes them in"),
    (["--max_batch", "1"], r"exported for \(B, T, H, W\) = \(2, 3, 32, 48\)"),
    (["--frame_width", "64"], r"= \(2, 3, 32, 64\)"),
    (["--mesh_data", "2", "--num_processes", "2", "--coordinator", "127.0.0.1:1"],
     "no mesh"),
    (None, "does not exist"),
])
def test_artifact_refusals(artifact, tmp_path, capsys, extra, message):
    import re

    path = str(tmp_path / "missing.gcdexp") if extra is None else artifact
    argv = ["--device", "cpu", "--config_path", TINY_CONFIG, "--num_frames", str(T),
            "--frame_width", str(W), "--frame_height", str(H), "--artifact", path,
            *(extra or [])]
    with pytest.raises(SystemExit) as exc:
        serve_main(argv)
    assert exc.value.code == 2
    assert re.search(message, capsys.readouterr().err)

"""The port's serving path on the CPU: the request batcher
(engine/server.py), the HTTP front end (serve.py), the request batch a
client builds (engine/bundle.py) against scripts/eval_utils.py, and
released-checkpoint loading with the EMA overlay (io/checkpoint.py) against
gcd_tpu/io/convert.py.

The engine is the port's tiny one (configs/smoke_kubric_tiny.yaml) on the
CPU in fp32 with 2 sampling steps, 3-frame 32x48 clips, decoded a clip at a
time. A request's frames must not depend on its batch-mates: served beside
another and served alone (padded with a copy of itself) they differ only in
the order of fp32 sums, against a bound of 1e-5 relative L2.
"""

import io
import json
import struct
import threading
import types
import urllib.request
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
from gcd_tpu_torch.serve import make_handler
from scripts import eval_utils
from tests.torch_port_helpers import TINY_CONFIG, rel_l2

T, H, W = 3, 32, 48
TOL = 1e-5


def _clip(bundle, seed, azimuth):
    frames = np.random.default_rng(seed).uniform(size=(T, H, W, 3))
    return construct_batch(frames, azimuth, 5.0, 0.0, T, 5, 127, 0.02, False, bundle)


@pytest.fixture(scope="module")
def bundle():
    return load_model_bundle(TINY_CONFIG, None, num_steps=2, num_frames=T, device="cpu",
                             dtype=torch.float32)


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

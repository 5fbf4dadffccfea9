"""Local HTTP front end for the batched sampler (port of scripts/serve.py).

    python -m gcd_tpu_torch.serve --config_path configs/infer_kubric.yaml \\
        [--model_path <ckpt>] [--support_ema] --port 8188 --max_batch 2 [--num_steps 25]
    # from an exported sampler (python -m gcd_tpu_torch.export_artifact)
    python -m gcd_tpu_torch.serve --config_path ... --artifact sampler.gcdexp
    # each batch over N processes, one a card (gloo with --device cpu)
    python -m gcd_tpu_torch.serve --config_path ... --coordinator host:port \\
        --num_processes N --process_id i --mesh_data D [--mesh_fsdp F] [--mesh_tensor TP]

POST /sample with an .npz body of one clip's batch arrays, each with a
(T, ...) leading axis (cond_frames, cond_frames_without_noise, cond_aug,
motion_bucket_id, fps_id, scaled_relative_angles or scaled_relative_pose,
image_only_indicator (1, T): what engine/bundle.py `construct_batch`
makes), and optionally an integer `seed` for the clip's noise, returns an
.npz of the sample_video outputs (sampled_video (T, H, W, 3) in [0, 1] and
the rest). Concurrent requests are batched onto one fixed-shape engine call
by engine/server.py. GET /healthz reports the counters.

The engine is built on the card (the CPU only with --device cpu), with the
checkpoint's weights, or seeded random weights without --model_path, and
warmed up on a batch of --max_batch clips before the port opens.
`--num_steps` defaults to the config's sampler steps (25).

`--artifact` serves an exported sampler (engine/export.py load_sampler) with
the bundle's weights, as scripts/serve.py's --artifact does: a path that
does not exist, --num_steps or --decoding_t beside it (the artifact bakes
them in), an artifact exported for another batch than --max_batch clips of
the served (T, H, W), and a mesh (scripts/serve.py's artifact mode has
none) are refused. Any sampler exports; one that draws noise at every step
(churn, the ancestral samplers) takes each request's from its seed after
its latent noise, as the eager server does, so the two serve the same
frames for the same seeds.

The process and mesh flags are the inference entries' (eval_utils.py
add_mesh_arguments, join_mesh). scripts/serve.py has none: they are the
port's way of running what the JAX package composes in
tests/test_server_sharded.py, SamplerServer over the sharded sampler
(engine/serving.py), here one process a card. Process 0 alone opens the
port, prints the "serving on" line and batches the requests; it sends each
batch to the other processes, which sample it with it (engine/server.py
`follow`). Ctrl-C (SIGINT) on process 0 stops every process with exit
code 0; when the processes fall out of step, every one exits non-zero.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


def make_handler(server_obj, num_frames: int):
    """The request handler class over a SamplerServer."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            self._reply(200, json.dumps({
                "ok": True, "num_frames": num_frames,
                "batches_run": server_obj.batches_run,
                "requests_served": server_obj.requests_served}).encode(), "application/json")

        def do_POST(self):
            if self.path != "/sample":
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                data = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                clip = {k: data[k] for k in data.files}
                seed = clip.pop("seed", None)
                clip["num_video_frames"] = num_frames
                out = server_obj.submit(clip, None if seed is None else int(seed)).result(
                    timeout=600)
                buf = io.BytesIO()
                np.savez(buf, **out)
                self._reply(200, buf.getvalue(), "application/x-npz")
            except Exception as e:
                self._reply(500, f"{type(e).__name__}: {e}".encode(), "text/plain")

    return Handler


def get_parser() -> argparse.ArgumentParser:
    from gcd_tpu_torch.eval_utils import add_mesh_arguments

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config_path", required=True)
    p.add_argument("--model_path", default=None,
                   help=".ckpt / .pt / .safetensors; seeded random weights without it")
    p.add_argument("--support_ema", action="store_true",
                   help="sample with the checkpoint's EMA weights")
    p.add_argument("--port", type=int, default=8188)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--num_frames", type=int, default=14)
    p.add_argument("--frame_width", type=int, default=384)
    p.add_argument("--frame_height", type=int, default=256)
    p.add_argument("--max_batch", type=int, default=2)
    p.add_argument("--max_wait_ms", type=float, default=50.0)
    p.add_argument("--num_steps", type=int, default=None,
                   help="sampler steps (default: the config's, 25)")
    p.add_argument("--decoding_t", type=int, default=None)
    p.add_argument("--artifact", default=None,
                   help="an exported sampler of gcd_tpu_torch.export_artifact: serve it")
    p.add_argument("--device", default=None, help="cuda when omitted; 'cpu' to run there")
    add_mesh_arguments(p)
    return p


def check_artifact(p: argparse.ArgumentParser, args) -> None:
    """Refuse the misuses of --artifact, before anything is built: a path
    that does not exist, --num_steps or --decoding_t beside it, a mesh, an
    artifact exported for another batch than --max_batch clips of the
    served (T, H, W)."""
    from gcd_tpu_torch.engine.export import baked_batch

    if not os.path.exists(args.artifact):
        p.error(f"--artifact {args.artifact!r} does not exist")
    if args.num_steps is not None or args.decoding_t is not None:
        p.error("--num_steps/--decoding_t cannot be combined with --artifact: the exported "
                "sampler bakes them in (export again with gcd_tpu_torch.export_artifact)")
    if args.coordinator or args.num_processes > 1 or \
            args.mesh_data * args.mesh_fsdp * args.mesh_tensor > 1:
        p.error("--artifact serves on one card: it takes no mesh or process group")
    with open(args.artifact, "rb") as f:
        baked = baked_batch(f.read())
    served = (args.max_batch, args.num_frames, args.frame_height, args.frame_width)
    if tuple(baked) != served:
        p.error(f"--artifact was exported for (B, T, H, W) = {tuple(baked)}; this server "
                f"takes --max_batch x (--num_frames, --frame_height, --frame_width) = {served}")


def load_artifact(path: str, params, max_batch: int, num_frames: int, frame_hw):
    """(sample_fn, check) for SamplerServer over the exported sampler at
    `path` with the weights `params`."""
    from gcd_tpu_torch.engine.export import load_sampler
    from gcd_tpu_torch.engine.server import batch_check, make_artifact_sample_fn

    with open(path, "rb") as f:
        sample = load_sampler(f.read())
    return (make_artifact_sample_fn(sample, params, max_batch, num_frames),
            batch_check(sample.header["keys"], max_batch, num_frames, frame_hw))


def main(argv=None) -> None:
    from gcd_tpu_torch import eval_utils
    from gcd_tpu_torch.parallel import distributed

    p = get_parser()
    args = p.parse_args(argv)
    if args.artifact:
        check_artifact(p, args)
    owns_group = eval_utils.join_mesh(args, "gcd_tpu_torch.serve")
    try:
        _main(args, owns_group)
    finally:
        if owns_group:
            distributed.shutdown()


def _main(args, in_group: bool) -> None:
    from gcd_tpu_torch.engine.bundle import load_model_bundle
    from gcd_tpu_torch.engine.server import (SamplerServer, batch_check, follow,
                                             make_engine_sample_fn, sample_keys)
    from gcd_tpu_torch.parallel import distributed
    from gcd_tpu_torch.parallel.mesh import create_mesh

    bundle = load_model_bundle(
        args.config_path, args.model_path, support_ema=args.support_ema,
        num_steps=args.num_steps, num_frames=args.num_frames, device=args.device,
        dtype=torch.float32 if args.device == "cpu" else torch.bfloat16,
        verbose=distributed.is_main())
    engine = bundle.engine.requires_grad_(False)
    device = next(engine.parameters()).device
    hw = (args.frame_height, args.frame_width)
    if args.artifact:
        fn, check = load_artifact(args.artifact, engine.state_dict(), args.max_batch,
                                  args.num_frames, hw)
    else:
        mesh = (create_mesh(args.mesh_data, args.mesh_fsdp, args.mesh_tensor, device.type)
                if in_group else None)
        fn = make_engine_sample_fn(engine, args.max_batch, args.num_frames,
                                   decoding_t=args.decoding_t, mesh=mesh)
        check = batch_check(sample_keys(engine), args.max_batch, args.num_frames, hw)
    fn(engine.example_batch(hw, args.num_frames, args.max_batch), [0] * args.max_batch)
    if not distributed.is_main():
        follow(fn, device)
        return
    srv = SamplerServer(fn, args.num_frames, max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms, check=check,
                        mesh_device=device if in_group else None).start()
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(srv, args.num_frames))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    print(f"warmed up (B={args.max_batch}, T={args.num_frames}); "
          f"serving on http://{args.host}:{httpd.server_address[1]}", flush=True)
    try:
        while not srv.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop(timeout=600.0)
    if srv.error is not None:
        raise SystemExit(f"gcd_tpu_torch.serve: the mesh fell out of step: {srv.error}")


if __name__ == "__main__":
    main()

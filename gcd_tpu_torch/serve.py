"""Local HTTP front end for the batched sampler (port of scripts/serve.py).

    python -m gcd_tpu_torch.serve --config_path configs/infer_kubric.yaml \\
        [--model_path <ckpt>] [--support_ema] --port 8188 --max_batch 2 [--num_steps 25]

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
warmed up on a batch of --max_batch clips before the port opens. It has no
exported-artifact mode (scripts/serve.py's --artifact): an artifact of
gcd_tpu_torch.export_artifact is loaded with engine/export.py load_sampler.
"""

from __future__ import annotations

import argparse
import io
import json
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


def main(argv=None) -> None:
    from gcd_tpu_torch.engine.bundle import load_model_bundle
    from gcd_tpu_torch.engine.server import SamplerServer, make_engine_sample_fn

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
    p.add_argument("--num_steps", type=int, default=25)
    p.add_argument("--decoding_t", type=int, default=None)
    p.add_argument("--device", default=None, help="cuda when omitted; 'cpu' to run there")
    args = p.parse_args(argv)

    bundle = load_model_bundle(
        args.config_path, args.model_path, support_ema=args.support_ema,
        num_steps=args.num_steps, num_frames=args.num_frames, device=args.device,
        dtype=torch.float32 if args.device == "cpu" else torch.bfloat16, verbose=True)
    fn = make_engine_sample_fn(bundle.engine, args.max_batch, args.num_frames,
                               decoding_t=args.decoding_t)
    srv = SamplerServer(fn, args.num_frames, max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms).start()
    warm = bundle.engine.example_batch((args.frame_height, args.frame_width),
                                       args.num_frames, args.max_batch)
    fn(warm, [0] * args.max_batch)
    print(f"warmed up (B={args.max_batch}, T={args.num_frames}); "
          f"serving on http://{args.host}:{args.port}", flush=True)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(srv, args.num_frames))
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        srv.stop()


if __name__ == "__main__":
    main()

"""Export the sampling program as a serving artifact (port of
scripts/export_artifact.py).

    python -m gcd_tpu_torch.export_artifact --config_path configs/infer_kubric.yaml \\
        --model_path <ckpt | run/checkpoints/step_N> --output sampler_384x256x14.gcdexp \\
        [--num_steps 25] [--decoding_t 14] [--batch 1] [--random_init] [--device cpu]

Builds the engine (engine/bundle.py load_model_bundle: the checkpoint's
weights, or seeded random ones with --random_init), and writes
engine/export.py's artifact for a fixed (--batch, --num_frames,
--frame_height, --frame_width): the conditioner, the config's sampler
(Euler's step, or any other sampler's denoiser evaluation: Heun,
Euler-ancestral, DPM++ 2S / 2M, LMS, Euler with churn) and the decode as
torch.export programs, weights left out. The artifact and the
weights are what a serving host needs (engine/export.py load_sampler).
The artifact runs on the device it was exported on and with the torch
version that wrote it: the CUDA card in bf16, or with --device cpu the CPU
in fp32 (scripts/export_artifact.py's --platforms). Without CUDA and without
--device cpu it raises. `main(argv)` returns the artifact's bytes.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="gcd_tpu_torch sampler export")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--frame_width", type=int, default=384)
    p.add_argument("--frame_height", type=int, default=256)
    p.add_argument("--num_frames", type=int, default=14)
    p.add_argument("--batch", type=int, default=1,
                   help="clips per serving request (leading (B*T) axis)")
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--decoding_t", type=int, default=None)
    p.add_argument("--random_init", action="store_true",
                   help="export with seeded random weights (the weights are inputs, so "
                        "the artifact serves any checkpoint of the config)")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' to export for the CPU (fp32); default: the CUDA card (bf16)")
    return p


def main(argv=None) -> bytes:
    from gcd_tpu_torch.engine.bundle import load_model_bundle
    from gcd_tpu_torch.engine.export import export_sampler

    p = get_parser()
    args = p.parse_args(argv)
    if args.device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("gcd_tpu_torch.export_artifact: no CUDA device; pass "
                               "--device cpu to export for the CPU")
        args.device = "cuda"
    if not (args.random_init or args.model_path):
        p.error("--model_path is required without --random_init")
    num_steps: Optional[int] = args.num_steps
    bundle = load_model_bundle(
        args.config_path, None if args.random_init else args.model_path,
        num_frames=args.num_frames, device=args.device,
        dtype=torch.float32 if args.device == "cpu" else torch.bfloat16,
        **({} if num_steps is None else {"num_steps": num_steps}))
    engine = bundle.engine
    batch = engine.example_batch((args.frame_height, args.frame_width), args.num_frames,
                                 args.batch, device=args.device)
    blob = export_sampler(engine, engine.state_dict(), batch, num_steps=num_steps,
                          decoding_t=args.decoding_t)
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"wrote {args.output}: {len(blob) / 1e6:.2f} MB (shapes: B={args.batch} "
          f"T={args.num_frames} {args.frame_height}x{args.frame_width}, {args.device})")
    return blob


if __name__ == "__main__":
    main()

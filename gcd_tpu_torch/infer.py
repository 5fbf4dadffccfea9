"""Inference on arbitrary clips and images, without ground truth (port of
scripts/infer.py).

    python -m gcd_tpu_torch.infer --config_path configs/infer_kubric.yaml \
        --model_path <ckpt | run/checkpoints/step_N> --input <file | dir | glob | list.txt> \
        --output eval_output/infer --azimuth 30 --elevation 15 --radius 0
    python -m gcd_tpu_torch.infer --device cpu --config_path configs/smoke_kubric_tiny.yaml ...

Each input (a .png image, repeated to the clip's frames, or an .npz clip of
`frames` (T, H, W, 3), uint8 or float in [0, 1]) becomes one batch
(engine/bundle.py construct_batch) with the camera move; `--num_samples`
samples of it are drawn, each with its own latent noise. Written to
`--output`: `{base}_out{s}` (sample s), `{base}_in` (the conditioning
frames) and `{base}_ioside` (input beside sample 0), each as `.npz` (uint8
`frames`, `fps`) and a `.png` strip (eval_utils.write_video_and_frames, in
place of the reference's MP4), `{base}_metrics.json` with the samples'
`diversity_std`, and `summary.json`.

The noise of sample s of input i comes from a torch.Generator seeded with
eval_utils.sample_seed(--seed, i, s); JAX's `fold_in` of the reference has
no torch counterpart, so the samples are not the JAX entry's. On the CUDA
card in bf16, unless `--device cpu` asks for the CPU (fp32); without CUDA
and without that flag it raises. The reference's mesh options (multi-chip
serving) are not accepted. `main(argv)` returns what summary.json holds.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np

from gcd_tpu_torch import eval_utils
from gcd_tpu_torch.engine.bundle import construct_batch
from gcd_tpu_torch.utils.metrics import sample_diversity


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="gcd_tpu_torch inference")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--model_path", type=str, default="")
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--output", type=str, default="eval_output/infer")
    p.add_argument("--num_samples", type=int, default=2)
    p.add_argument("--num_steps", type=int, default=25)
    p.add_argument("--num_frames", type=int, default=14)
    p.add_argument("--frame_width", type=int, default=384)
    p.add_argument("--frame_height", type=int, default=256)
    p.add_argument("--frame_offset", type=int, default=0)
    p.add_argument("--frame_stride", type=int, default=1)
    p.add_argument("--frame_rate", type=int, default=12)
    p.add_argument("--input_frames", type=int, default=14)
    p.add_argument("--azimuth", type=float, default=30.0)
    p.add_argument("--elevation", type=float, default=15.0)
    p.add_argument("--radius", type=float, default=0.0)
    p.add_argument("--guider_max_scale", type=float, default=1.5)
    p.add_argument("--guider_min_scale", type=float, default=1.0)
    p.add_argument("--guidance_interval", type=str, default="",
                   help="lo,hi sigma band: CFG only inside it (opt-in speed mode)")
    p.add_argument("--motion_bucket", type=int, default=127)
    p.add_argument("--force_custom_mbid", action="store_true")
    p.add_argument("--cond_aug", type=float, default=0.02)
    p.add_argument("--decoding_t", type=int, default=14)
    p.add_argument("--autocast", type=int, default=1,
                   help="the reference's flag; the port samples in bf16 on the card, "
                        "fp32 on the CPU")
    p.add_argument("--support_ema", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_frames", action="store_true")
    p.add_argument("--shard", type=str, default="0/1",
                   help="i/n example sharding across separate launches")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' to run on the CPU (fp32); default: the CUDA card (bf16)")
    return p


def process_example(bundle, sampler, args, input_fp: str, out_dp: str, index: int) -> Dict:
    """Sample one input `--num_samples` times and write its files."""
    input_rgb = eval_utils.load_image_or_video(
        input_fp, args.num_frames, args.frame_offset, args.frame_stride, center_crop=True,
        frame_width=args.frame_width, frame_height=args.frame_height)
    batch = construct_batch(input_rgb, args.azimuth, args.elevation, args.radius,
                            args.input_frames, args.frame_rate, args.motion_bucket,
                            args.cond_aug, args.force_custom_mbid, bundle,
                            rng=np.random.default_rng(args.seed))
    samples, sample_s = [], []
    for s in range(args.num_samples):
        t0 = time.perf_counter()
        out = sampler(batch, eval_utils.sample_seed(args.seed, index, s))
        samples.append(out["sampled_video"])
        sample_s.append(time.perf_counter() - t0)
        print(f"  sample {s}: {sample_s[-1]:.1f}s", flush=True)

    base = os.path.splitext(os.path.basename(input_fp))[0]
    cond_vid = out["cond_video"]
    for s, sampled in enumerate(samples):
        eval_utils.write_video_and_frames(out_dp, f"{base}_out{s}", sampled, fps=args.frame_rate,
                                          save_frames=args.save_frames)
    eval_utils.write_video_and_frames(out_dp, f"{base}_in", cond_vid, fps=args.frame_rate)
    eval_utils.write_video_and_frames(out_dp, f"{base}_ioside",
                                      np.concatenate([cond_vid, samples[0]], axis=2),
                                      fps=args.frame_rate)
    metrics = {"input": input_fp, "azimuth": args.azimuth, "elevation": args.elevation,
               "radius": args.radius, "diversity_std": sample_diversity(samples),
               "sample_seconds": sample_s}
    with open(os.path.join(out_dp, f"{base}_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics


def main(argv=None) -> Dict:
    args = get_parser().parse_args(argv)
    bundle = eval_utils.load_bundle(args.config_path, args.model_path, args)
    sampler = eval_utils.make_sampler(bundle, decoding_t=args.decoding_t)

    inputs = eval_utils.resolve_input_paths(args.input)
    shard_i, shard_n = map(int, args.shard.split("/"))
    inputs = inputs[shard_i::shard_n]
    print(f"Processing {len(inputs)} inputs (shard {args.shard})...", flush=True)

    os.makedirs(args.output, exist_ok=True)
    all_metrics = []
    for i, fp in enumerate(inputs):
        print(f"[{i + 1}/{len(inputs)}] {fp}", flush=True)
        all_metrics.append(process_example(bundle, sampler, args, fp, args.output, i))

    summary = {"num_examples": len(all_metrics),
               "mean_diversity": float(np.mean([m["diversity_std"] for m in all_metrics]))
               if all_metrics else 0.0}
    result = {"summary": summary, "examples": all_metrics}
    with open(os.path.join(args.output, "summary.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(f"Done. {summary}", flush=True)
    return result


if __name__ == "__main__":
    main()

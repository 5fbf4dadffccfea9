"""Evaluation with ground truth (port of scripts/test.py).

    python -m gcd_tpu_torch.test --config_path configs/infer_kubric.yaml \
        --model_path <run>/checkpoints/step_N --input eval/list/kubric_test20.txt \
        --output eval_output/test --generate_controls
    python -m gcd_tpu_torch.test --device cpu --config_path configs/smoke_kubric_tiny.yaml ...
    # one clip's sampling split over N processes (one a card, or gloo with --device cpu)
    python -m gcd_tpu_torch.test ... --coordinator host:port --num_processes N \
        --process_id i --mesh_data D [--mesh_fsdp F] [--mesh_tensor TP]

Each scene of `--input` (a list file of scene paths, or comma-separated
Kubric scene indices / ParallelDomain scene names) gets `--samples_per_scene`
camera controls: those of `--controls_json`, or, where that file is absent,
controls drawn with a fixed seed from the schema of the reference's
kubric_valtest_controls_*.json (`generate_controls`, the JAX entry's draws).
An example is rendered through the training config's data module, its
validation split in `set_next_example` mode with `reproject_rgbd = True`
(the target frames and the RGBD-reprojection baseline), then sampled
`--num_samples` times by every model of the pool (comma-separated
`--config_path` / `--model_path`), each sample's noise from a
torch.Generator seeded with eval_utils.sample_seed(--seed, example, sample)
(JAX's fold_in has no torch counterpart, so the samples are not the JAX
entry's). Metrics (utils/metrics.py): per-frame PSNR and SSIM, their
visible and occluded variants split by the baseline's holes (and the share
of pixels it covers), the samples' diversity, and mIoU for a semantic
(`segm`) output. Written per model under
`--output`/{model name}: `{tag}_out{s}.npz` / `.png` (eval_utils), the
`--galleries` layouts of galleries.py (default rich1, rich2, rich3, rich5
and rich6; `all` for rich1-rich7; rich4 shows the samples' latents, which
the sampler returns) as `{tag}_{suffix}.npz` / `.png`, the per-example
`{tag}_metrics.json` with the per-frame (samples, frames) arrays, and
`summary_metrics.json` with the means, every example, and the tags that
failed. An example that fails is reported with its traceback and the loop
goes on.

On the CUDA card in bf16, unless
`--device cpu` asks for the CPU (fp32); without CUDA and without that flag
it raises. With `--coordinator` the processes split each clip's sampling
over the mesh `--mesh_data` x `--mesh_fsdp` x `--mesh_tensor` (their
product must be `--num_processes`; eval_utils.py, engine/serving.py): every
process renders the same examples and samples the same clips, process 0
alone computes the metrics, builds the galleries and writes the files. `--shard i/n` splits the
scenes over independent launches, which is another thing. `main(argv)`
returns, per model, what summary_metrics.json holds (an empty list on the
other processes).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np

from gcd_tpu_torch import eval_utils, galleries
from gcd_tpu_torch.data.loader import collate_fn
from gcd_tpu_torch.parallel import distributed
from gcd_tpu_torch.utils.config import get_by_path, instantiate_from_config
from gcd_tpu_torch.utils.metrics import clip_metrics, miou, rgb_to_class_ids, sample_diversity

CONTROLS_SEED = 4
# clip_metrics' mask_threshold: a baseline pixel summing above it is visible.
VISIBLE_THRESHOLD = 0.05
# Per-clip scalars of clip_metrics' per-frame arrays: (ours, clip_metrics').
MASKED_KEYS = (("psnr_visible", "psnr_vis"), ("psnr_occluded", "psnr_occ"),
               ("ssim_visible", "ssim_vis"), ("ssim_occluded", "ssim_occ"))


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="gcd_tpu_torch evaluation")
    p.add_argument("--config_path", type=str, required=True,
                   help="config yaml; comma-separate for multi-model eval")
    p.add_argument("--model_path", type=str, default="",
                   help="checkpoint; comma-separate to evaluate a pool of models on "
                        "identical examples")
    p.add_argument("--galleries", type=str, default=",".join(galleries.DEFAULT_LAYOUTS),
                   help="comma list of gallery layouts (rich1..rich7 or 'all'); see "
                        "gcd_tpu_torch/galleries.py")
    p.add_argument("--input", type=str, required=True,
                   help="scene list txt (eval/list/kubric_test*.txt) or comma-separated "
                        "scene indices")
    p.add_argument("--output", type=str, default="eval_output/test")
    p.add_argument("--controls_json", type=str, default="")
    p.add_argument("--generate_controls", action="store_true",
                   help="regenerate controls with a fixed RNG when the json is unavailable")
    p.add_argument("--samples_per_scene", type=int, default=2)
    p.add_argument("--num_samples", type=int, default=2, help="diffusion samples per example")
    p.add_argument("--num_steps", type=int, default=25)
    p.add_argument("--num_frames", type=int, default=14)
    p.add_argument("--frame_width", type=int, default=384)
    p.add_argument("--frame_height", type=int, default=256)
    p.add_argument("--guider_max_scale", type=float, default=1.5)
    p.add_argument("--guider_min_scale", type=float, default=1.0)
    p.add_argument("--guidance_interval", type=str, default="",
                   help="lo,hi sigma band: CFG only inside it (opt-in speed mode)")
    p.add_argument("--decoding_t", type=int, default=14)
    p.add_argument("--support_ema", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shard", type=str, default="0/1")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' to run on the CPU (fp32); default: the CUDA card (bf16)")
    eval_utils.add_mesh_arguments(p)
    return p


def parse_scene_list(spec: str) -> List:
    """A list file of paths like .../scn02900 (-> 2900) or .../scene_XXXXXX
    (kept as names), or comma-separated indices and names."""
    if spec.endswith(".txt"):
        with open(spec) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        out = []
        for ln in lines:
            base = os.path.basename(ln.rstrip("/"))
            if base.startswith("scn"):
                out.append(int(base[3:]))
            elif base.startswith("scene_"):
                out.append(base)
            else:
                out.append(ln)
        return out
    return [int(part) if part.isdigit() else part
            for part in (p.strip() for p in spec.split(","))]


def generate_controls(scenes, samples_per_scene: int, bundle, seed: int = CONTROLS_SEED) -> Dict:
    """Per scene, `sample_XX`: {spherical_start, spherical_end, frame_start,
    frame_skip}, drawn from np.random.default_rng(seed) over the train
    config's camera and frame ranges (ParallelDomain: 50 frames, skip 1-2)."""
    rng = np.random.default_rng(seed)
    tc = bundle.train_config or {}
    dp = get_by_path(tc, "data.params", {}) or {}
    az_range = dp.get("azimuth_range", [0.0, 360.0])
    el_range = dp.get("elevation_range", [0.0, 50.0])
    r_range = dp.get("radius_range", [12.0, 18.0])
    d_az = dp.get("delta_azimuth_range", bundle.delta_azimuth_range)
    d_el = dp.get("delta_elevation_range", bundle.delta_elevation_range)
    d_r = dp.get("delta_radius_range", bundle.delta_radius_range)
    if "pardom" in str(get_by_path(tc, "data.target", "")):
        avail, max_skip = 50, 2
    else:
        avail, max_skip = int(dp.get("avail_frames", 60)), None
    tcm = int(dp.get("model_frames", 14))

    controls = {}
    for scene in scenes:
        sd = {}
        for i in range(samples_per_scene):
            az_s = rng.uniform(*az_range)
            el_s = rng.uniform(*el_range)
            r_s = rng.uniform(*r_range)
            az_e = az_s + rng.uniform(*d_az)
            el_e = float(np.clip(el_s + rng.uniform(*d_el), *el_range))
            r_e = float(np.clip(r_s + rng.uniform(*d_r), *r_range))
            skip_hi = max_skip if max_skip is not None else max(avail // tcm, 1)
            frame_skip = int(rng.integers(1, skip_hi + 1))
            cover = frame_skip * (tcm - 1) + 1
            frame_start = int(rng.integers(0, max(avail - cover - 1, 0) + 1))
            sd[f"sample_{i:02d}"] = {
                "spherical_start": [float(az_s), float(el_s), float(r_s)],
                "spherical_end": [float(az_e), float(el_e), float(r_e)],
                "frame_start": frame_start,
                "frame_skip": frame_skip,
            }
        controls[str(scene)] = sd
    return controls


def build_eval_dataset(bundle, args):
    """The train config's data module at the eval frame size: its
    validation split, with the reprojection baseline."""
    tc = bundle.train_config
    if tc is None:
        raise ValueError("the evaluation needs a train config (beside the checkpoint, or "
                         "a config with a data section) to rebuild the data pipeline")
    params = dict(tc["data"].get("params", {}),
                  frame_width=args.frame_width, frame_height=args.frame_height)
    dset = instantiate_from_config({"target": tc["data"]["target"], "params": params}).val_dataset
    dset.reproject_rgbd = True
    return dset


def render_example(dset, scene, control) -> Tuple[Dict, float]:
    """One eval example, collated, and the seconds its render took: a
    Kubric scene index or a ParallelDomain scene name with its control."""
    if isinstance(scene, int):
        ss, se = control["spherical_start"], control["spherical_end"]
        dset.set_next_example(scene, control["frame_skip"], control["frame_start"], False,
                              ss[0], se[0], ss[1], se[1], ss[2], se[2])
    else:
        dset.set_next_example(0, scene, control["frame_skip"], control["frame_start"], False)
    t0 = time.perf_counter()
    example = dset[0]
    render_s = time.perf_counter() - t0
    print(f"  data render: {render_s:.1f}s", flush=True)
    return collate_fn([example]), render_s


def process_example(sampler, args, dset, batch: Dict, render_s: float, scene, control,
                    example_index: int, out_dp: str, tag: str, model_name: str = "random",
                    enabled: tuple = galleries.DEFAULT_LAYOUTS) -> Optional[Dict]:
    """Sample one rendered example, compute its metrics, build its
    galleries, write its files (process 0; the others sample with it and
    return None)."""
    gt = (batch["jpg"] + 1.0) / 2.0
    reproject = (batch["reproject"] + 1.0) / 2.0 if "reproject" in batch else None
    samples, latents, sample_s = [], [], []
    for s in range(args.num_samples):
        t0 = time.perf_counter()
        out = sampler(batch, eval_utils.sample_seed(args.seed, example_index, s))
        samples.append(out["sampled_video"])
        if "sampled_z" in out:
            latents.append(out["sampled_z"])
        sample_s.append(time.perf_counter() - t0)
        print(f"  sample {s}: {sample_s[-1]:.1f}s", flush=True)
    if not distributed.is_main():
        return None

    t0 = time.perf_counter()
    frame_metrics, uncertainty = clip_metrics(samples, gt, reproject)
    metrics = {"psnr": float(np.nanmean(frame_metrics["frame_psnr"])),
               "ssim": float(np.nanmean(frame_metrics["frame_ssim"])),
               "diversity_std": sample_diversity(samples)}
    if reproject is not None:
        for ours, ref in MASKED_KEYS:
            metrics[ours] = float(np.nanmean(frame_metrics[f"frame_{ref}"]))
        # The share of pixels the baseline covers: clip_metrics' visible mask.
        metrics["visible_share"] = float((reproject.sum(-1) > VISIBLE_THRESHOLD).mean())
    if getattr(dset, "output_modality", "rgb") == "segm":
        # The semantic head: colours matched back to the ontology's classes.
        palette = np.asarray(dset.ontology["semantic_id_rgb_map"])
        gt_ids = [rgb_to_class_ids(g, palette) for g in gt]
        metrics["miou"] = float(np.nanmean([miou(rgb_to_class_ids(f, palette), g_ids)
                                            for sample in samples
                                            for f, g_ids in zip(sample, gt_ids)]))
    metrics_s = time.perf_counter() - t0
    metrics["scene"] = str(scene)
    metrics["control"] = control

    t0 = time.perf_counter()
    vis = galleries.create_visualizations(
        out["cond_video"], gt, samples, frame_metrics, uncertainty=uncertainty,
        reproject_rgb=reproject, pred_samples_latent=latents or None, model_name=model_name,
        target_title=f"Target ({galleries.controls_friendly_title(control)})", enable=enabled)
    galleries.save_visualizations(vis, out_dp, tag, frame_rate=int(control.get("frame_rate", 8)))
    metrics["seconds"] = {"render": render_s, "samples": sample_s, "metrics": metrics_s,
                          "galleries": time.perf_counter() - t0}

    for s, sample in enumerate(samples):
        eval_utils.write_video_and_frames(out_dp, f"{tag}_out{s}", sample)
    with open(os.path.join(out_dp, f"{tag}_metrics.json"), "w") as f:
        json.dump({**metrics, **{k: np.asarray(v).tolist() for k, v in frame_metrics.items()}},
                  f, indent=2)
    return metrics


def output_dirs(output: str, bundles) -> List[str]:
    """One directory a model, by its short name; a repeated name gets _1,
    _2, ... so that two models' files never collide. Made by process 0."""
    dps, seen = [], {}
    for b in bundles:
        name = b.model_name
        if name in seen:
            seen[name] += 1
            name = f"{name}_{seen[name]}"
        else:
            seen[name] = 0
        dps.append(os.path.join(output, name))
        if distributed.is_main():
            os.makedirs(dps[-1], exist_ok=True)
    return dps


def main(argv=None) -> List[Dict]:
    args = get_parser().parse_args(argv)
    owns_group = eval_utils.join_mesh(args, "gcd_tpu_torch.test")
    try:
        return _main(args)
    finally:
        if owns_group:
            distributed.shutdown()


def _main(args) -> List[Dict]:
    # The pool: every model sees every example, rendered once.
    config_paths = [c for c in args.config_path.split(",") if c]
    model_paths = [m for m in args.model_path.split(",") if m] or [""]
    if len(config_paths) == 1:
        config_paths = config_paths * len(model_paths)
    if len(config_paths) != len(model_paths):
        raise ValueError("need one --config_path per --model_path (or a single shared one)")
    enabled = galleries.parse_layouts(args.galleries)
    bundles = [eval_utils.load_bundle(cp, mp, args) for cp, mp in zip(config_paths, model_paths)]
    samplers = [eval_utils.make_sampler(b, decoding_t=args.decoding_t, return_latents=True,
                                        mesh_data=args.mesh_data, mesh_fsdp=args.mesh_fsdp,
                                        mesh_tensor=args.mesh_tensor)
                for b in bundles]

    scenes = parse_scene_list(args.input)
    shard_i, shard_n = map(int, args.shard.split("/"))
    scenes = scenes[shard_i::shard_n]
    if args.controls_json and os.path.exists(args.controls_json):
        with open(args.controls_json) as f:
            controls = json.load(f)
    else:
        if not args.generate_controls:
            print("No controls json found; regenerating deterministically "
                  "(pass --controls_json to use the official file).", flush=True)
        controls = generate_controls(scenes, args.samples_per_scene, bundles[0])

    dset = build_eval_dataset(bundles[0], args)
    out_dps = output_dirs(args.output, bundles)
    all_metrics = [[] for _ in bundles]
    failed = [[] for _ in bundles]
    n_ex = 0
    for i, scene in enumerate(scenes):
        for sample_name, control in sorted(controls.get(str(scene), {}).items()):
            tag = f"{scene}_{sample_name}"
            print(f"[{i + 1}/{len(scenes)}] {tag}", flush=True)
            try:
                batch, render_s = render_example(dset, scene, control)
            except Exception:  # report it, go on with the next example
                traceback.print_exc()
                print(f"  data render failed: {tag}", flush=True)
                for f in failed:
                    f.append(tag)
                continue
            for bi, (bundle, sampler) in enumerate(zip(bundles, samplers)):
                try:
                    m = process_example(sampler, args, dset, batch, render_s, scene, control,
                                        n_ex, out_dps[bi], tag, bundle.model_name, enabled)
                except Exception:  # report it, go on with the next model
                    traceback.print_exc()
                    print(f"  [{bundle.model_name}] failed: {tag}", flush=True)
                    failed[bi].append(tag)
                    continue
                if m is not None:
                    all_metrics[bi].append(m)
                    print(f"  [{bundle.model_name}] PSNR {m['psnr']:.2f} dB SSIM "
                          f"{m['ssim']:.3f}", flush=True)
            n_ex += 1

    if not distributed.is_main():
        return []
    results = []
    for bi, bundle in enumerate(bundles):
        ms = all_metrics[bi]
        summary = {k: float(np.nanmean([m[k] for m in ms]))
                   for k in ms[0] if isinstance(ms[0][k], (int, float))} if ms else {}
        result = {"summary": summary, "examples": ms, "failed": failed[bi]}
        with open(os.path.join(out_dps[bi], "summary_metrics.json"), "w") as f:
            json.dump(result, f, indent=2)
        print(f"[{bundle.model_name}] summary over {len(ms)} examples: {summary}", flush=True)
        results.append(dict(result, model_name=bundle.model_name, output=out_dps[bi]))
    return results


if __name__ == "__main__":
    main()

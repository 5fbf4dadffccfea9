"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero
without the final `ok` line):
  1. device      - require CUDA; print nvidia-smi's name and power limit.
  2. build       - compile gcd_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
                   process per source.
  3. conditioner - load_engine(configs/infer_kubric.yaml): random bf16
                   weights (std 0.02 on every leaf, seeded), ViT-H/14 tower;
                   one conditioner pass on a random 14-frame 384x256 batch;
                   checks the shapes of c and uc.
  4. kernels     - records every GroupNorm shape of that conditioner pass,
                   one CFG-doubled UNet evaluation and one 14-frame decode
                   (forward hooks), then holds each CUDA kernel against its
                   plain PyTorch version at every main-path shape, bf16,
                   relative L2 <= 1e-2: K1 flash attention, K2 temporal
                   attention, K3 fused GEGLU MLP, K4 GroupNorm, K5 group
                   statistics; K4 / K5 also on channels-first copies of those
                   shapes. CUDA-event and host enqueue times beside the bound
                   and the one-call library equivalent.
  5. ab          - the flagship UNet evaluation, the decode and the
                   conditioner with every kernel on vs off (relative
                   L2 <= 2e-2); the UNet's and the decode's wall times and
                   torch.profiler device time by kernel, with the GroupNorm
                   kernels on vs off.
  6. slice       - three requests through DiffusionEngine.sample_video:
                   random 14-frame 384x256 clips and camera moves, 25
                   Euler-EDM steps with per-frame CFG up to 1.5, one 14-frame
                   decode; checks the frames and each kernel's launch count.
Then the kernel JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "infer_kubric.yaml")
T, H, W = 14, 256, 384
HL, WL = H // 8, W // 8
BT = 2 * T  # CFG-doubled
SEED = 0
G = 32
KERNEL_TOL = 1e-2  # relative L2, the bf16 kernel gate of bench.py:211
AB_TOL = 2e-2      # relative L2, whole module, kernels on vs off
UC_KEYS = ("cond_frames", "cond_frames_without_noise")
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core and
# fp32 FLOP/s. `bound_ms` is the larger of bytes / HBM and operations / peak.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# (tokens per frame, channels) at the UNet's four attention resolutions, and
# how many transformer blocks each has per evaluation: ds1/ds2/ds4 have 2 in
# the input path and 3 in the output path, the middle block 1.
LEVELS = [("ds1", 1536, 320, 5), ("ds2", 384, 640, 5), ("ds4", 96, 1280, 5),
          ("mid", 24, 1280, 1)]
SOURCES = {
    "flash": ("gcd_tpu_torch/csrc/flash_attention.cu",
              "gcd_tpu/ops/flash_attention.py:55"),
    "tattn": ("gcd_tpu_torch/csrc/temporal_attention.cu",
              "gcd_tpu/ops/temporal_attention.py:47"),
    "fused_mlp": ("gcd_tpu_torch/csrc/fused_mlp.cu",
                  "gcd_tpu/ops/fused_mlp.py:108"),
    "fused_gn": ("gcd_tpu_torch/csrc/fused_norm.cu",
                 "gcd_tpu/ops/fused_norm.py:34"),
    "gn_stats": ("gcd_tpu_torch/csrc/fused_norm.cu",
                 "gcd_tpu/ops/fused_norm.py:94"),
}


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def rel_l2(a, b) -> float:
    if isinstance(a, tuple):
        a, b = torch.cat([t.flatten() for t in a]), torch.cat([t.flatten() for t in b])
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def max_abs(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_abs(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


def cuda_ms(fn, iters: int = 10):
    """(CUDA-event ms per call, host ms per call to enqueue it). Where the
    host takes longer than the device, the event time is the host's."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, 1e3 * host / iters


def wall_s(fn, reps: int = 3):
    """(last result, median seconds) of `reps` synchronized calls."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def device_profile(fn):
    """(Counter of device ms by kernel name, total device ms) over one call
    of fn under torch.profiler; (None, None) if it recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = Counter()
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key] += ev.self_device_time_total / 1e3
    total = sum(by_name.values())
    return (by_name, total) if total > 0 else (None, None)


def bound(nbytes: float, flops: float, peak: float):
    """(ms, what bounds it) for the least time the card could take."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def random_batch(gen: torch.Generator) -> dict:
    """A JAX-layout request: a random 14-frame clip in [-1, 1], its noised
    copy, and a random camera move."""
    def rand(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    frames = rand(T, H, W, 3) * 2.0 - 1.0
    return {"cond_frames": frames + 0.02 * torch.randn(frames.shape, generator=gen,
                                                       device="cuda"),
            "cond_frames_without_noise": frames,
            "cond_aug": torch.full((T,), 0.02, device="cuda"),
            "fps_id": torch.full((T,), 5.0, device="cuda"),
            "motion_bucket_id": torch.full((T,), 127.0, device="cuda"),
            "scaled_relative_angles": (rand(T, 3) * 2.0 - 1.0) * 0.5,
            "image_only_indicator": torch.zeros(1, T, device="cuda")}


def memory_layout(x: torch.Tensor) -> str:
    if x.is_contiguous():
        return "contiguous"
    fmt = {4: torch.channels_last, 5: torch.channels_last_3d}.get(x.dim())
    if fmt is not None and x.is_contiguous(memory_format=fmt):
        return "channels_last"
    return f"strides {x.stride()}"  # the (B, C, T, H, W) view of a (B, T, C, H, W) video


@contextmanager
def record_groupnorms(engine, counter: Counter):
    """Count every GroupNorm32 call by (shape, memory layout, eps, silu)."""
    from gcd_tpu_torch.models.layers import GroupNorm32

    def hook(mod, inputs, _):
        x = inputs[0]
        counter[(tuple(x.shape), memory_layout(x), mod.eps, mod.silu)] += 1

    handles = [m.register_forward_hook(hook) for m in engine.modules()
               if isinstance(m, GroupNorm32)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def site_label(site) -> str:
    shape, layout, eps, silu = site
    return f"{shape} {layout} eps={eps} silu={silu}"


def count_modules(module, cls) -> int:
    return sum(isinstance(m, cls) for m in module.modules())


def attention_mlp_cases(gen: torch.Generator, steps: int):
    """(kernel, label, launches per clip, kernel call, plain call, library
    call or None, bytes, operations, peak) for K1-K3."""
    from gcd_tpu_torch.ops import (flash_attention, flash_attention_plain, geglu_mlp,
                                   geglu_mlp_plain, temporal_attention,
                                   temporal_attention_plain)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    for name, s, c, blocks in LEVELS:
        heads = c // 64
        q, k, v = randn(BT, s, c), randn(BT, s, c), randn(BT, s, c)
        qkv_bytes = 4 * BT * s * c * 2
        sh = [z.reshape(BT, s, heads, 64).transpose(1, 2).contiguous() for z in (q, k, v)]
        yield ("flash", f"{name} ({BT},{s},{heads}x64)", blocks * steps,
               lambda q=q, k=k, v=v, h=heads: flash_attention(q, k, v, h),
               lambda q=q, k=k, v=v, h=heads: flash_attention_plain(q, k, v, h),
               lambda sh=sh: F.scaled_dot_product_attention(*sh),
               qkv_bytes, 4 * BT * s * s * c, BF16_FLOPS)
        th = [z.reshape(BT // T, T, s, heads, 64).permute(0, 2, 3, 1, 4)
              .reshape(BT // T * s, heads, T, 64).contiguous() for z in (q, k, v)]
        yield ("tattn", f"{name} ({BT},{s},{c}) T={T}", blocks * steps,
               lambda q=q, k=k, v=v, h=heads: temporal_attention(q, k, v, T, h),
               lambda q=q, k=k, v=v, h=heads: temporal_attention_plain(q, k, v, T, h),
               lambda th=th: F.scaled_dot_product_attention(*th),
               qkv_bytes, 4 * BT * s * T * c, BF16_FLOPS)
        m, inner = BT * s, 4 * c
        x = randn(m, c)
        w1, b1 = randn(2 * inner, c, std=c ** -0.5), randn(2 * inner, std=0.1)
        w2, b2 = randn(c, inner, std=inner ** -0.5), randn(c, std=0.1)
        yield ("fused_mlp", f"{name} M={m} C={c} I={inner}", 3 * blocks * steps,
               lambda a=(x, w1, b1, w2, b2): geglu_mlp(*a),
               lambda a=(x, w1, b1, w2, b2): geglu_mlp_plain(*a), None,
               2 * (2 * m * c + 3 * inner * c + 2 * inner + c), 6 * m * c * inner,
               BF16_FLOPS)


def groupnorm_cases(gen: torch.Generator, sites: Counter):
    """K4 and K5 cases at every recorded GroupNorm site: `sites` maps
    (shape, memory layout, eps, silu) to launches per clip."""
    from gcd_tpu_torch.ops import group_norm, group_norm_plain, group_stats, group_stats_plain
    from gcd_tpu_torch.ops.fused_norm import uses_split_path

    for site, per_clip in sorted(sites.items()):
        shape, layout, eps, silu = site
        c = shape[1]
        if layout == "contiguous":
            x = torch.randn(*shape, generator=gen, device="cuda")
        elif layout == "channels_last":
            x = torch.randn(shape[0], *shape[2:], c, generator=gen, device="cuda")
            x = x.movedim(-1, 1)
        else:  # the (B, C, T, H, W) view of a (B, T, C, H, W) buffer
            b, _, t, h, w = shape
            x = torch.randn(b, t, c, h, w, generator=gen, device="cuda").transpose(1, 2)
        if memory_layout(x) != layout:
            raise RuntimeError(f"made {memory_layout(x)} for a {layout} site")
        x = (x * 2.0 + 0.5).to(torch.bfloat16)
        wt = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        bs = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        n = x.numel()
        label = site_label(site)
        yield ("fused_gn", label, per_clip,
               lambda x=x, wt=wt, bs=bs, e=eps, s=silu: group_norm(x, wt, bs, G, e, s),
               lambda x=x, wt=wt, bs=bs, e=eps, s=silu: group_norm_plain(x, wt, bs, G, e, s),
               lambda x=x, wt=wt, bs=bs, e=eps: F.group_norm(x, G, wt, bs, e),
               4 * n + 4 * c, n * (12 if silu else 8), FP32_FLOPS)
        yield ("gn_stats", label, per_clip if uses_split_path(x, G) else 0,
               lambda x=x: group_stats(x, G), lambda x=x: group_stats_plain(x, G), None,
               2 * n + 16 * shape[0] * G, 2 * n, FP32_FLOPS)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    sys.path.insert(0, REPO)
    from gcd_tpu_torch.engine.build import load_engine
    from gcd_tpu_torch.models.attention import BasicTransformerBlock
    from gcd_tpu_torch.models.embedders import VideoPredictionEmbedderWithEncoder
    from gcd_tpu_torch.models.layers import FeedForward, GroupNorm32
    from gcd_tpu_torch.models.video_attention import VideoTransformerBlock
    from gcd_tpu_torch.ops import KERNELS, _native, kernel_flags

    t0 = time.perf_counter()
    _, ptxas = _native.build()
    _native.library()
    log("build", seconds=time.perf_counter() - t0,
        ptxas=[line.split(": ", 1)[-1] for line in ptxas.splitlines() if "Used" in line])

    # Phase 3: the conditioner at full width.
    t0 = time.perf_counter()
    engine = load_engine(CONFIG)
    log("engine", seconds=time.perf_counter() - t0,
        params=sum(p.numel() for p in engine.parameters()))
    unet = engine.model.diffusion_model
    steps = engine.sampler.num_steps
    gen = torch.Generator("cuda").manual_seed(SEED + 2)
    batch = random_batch(gen)
    gn_calls = {"cond": Counter(), "unet": Counter(), "decode": Counter()}
    with torch.no_grad():
        with record_groupnorms(engine, gn_calls["cond"]):
            c, uc = engine.get_unconditional_conditioning(batch, UC_KEYS)
        _, cond_s = wall_s(lambda: engine.get_unconditional_conditioning(batch, UC_KEYS))
    want = {"crossattn": (T, 1, 1024), "vector": (T, 896), "concat": (T, HL, WL, 4)}
    got = {"c": {k: tuple(v.shape) for k, v in c.items()},
           "uc": {k: tuple(v.shape) for k, v in uc.items()}}
    log("conditioner", seconds=cond_s, shapes=got, card=smi)
    if got["c"] != want or got["uc"] != want:
        raise RuntimeError(f"conditioner shapes {got}, expected {want} for c and uc")
    if not all(torch.isfinite(v).all() for v in (*c.values(), *uc.values())):
        raise RuntimeError("conditioner output not finite")
    if uc["crossattn"].any() or uc["concat"].any() or not torch.equal(uc["vector"], c["vector"]):
        raise RuntimeError("uc must zero the image embeddings and keep the vector")

    # Phase 4: record the UNet's and the decoder's GroupNorm sites, then every
    # kernel against its plain version at the main-path shapes.
    cond = {k: torch.cat([uc[k], c[k]]) for k in c}
    cond["concat"] = cond["concat"].permute(0, 3, 1, 2)
    # Latents channels-last, as DiffusionEngine.sample_latents makes them.
    x = torch.randn(BT, HL, WL, 4, generator=gen, device="cuda").permute(0, 3, 1, 2)
    sigma = torch.full((BT,), 1.0, device="cuda")
    ioi = torch.zeros(2, T, device="cuda")
    z = torch.randn(T, HL, WL, 4, generator=gen, device="cuda").permute(0, 3, 1, 2)

    def network(xin, c_noise, cc):
        return engine.network_fn(xin, c_noise, cc, T, ioi)

    def denoise():
        return engine.denoiser(network, x, sigma, cond)

    def decode():
        return engine.decode_first_stage(z, T)

    with torch.no_grad():
        with record_groupnorms(engine, gn_calls["unet"]):
            denoise()
        with record_groupnorms(engine, gn_calls["decode"]):
            decode()
    cond_encoders = [m.encoder.encoder for m in engine.conditioner.embedders
                     if isinstance(m, VideoPredictionEmbedderWithEncoder)]
    gn_modules = {"cond": sum(count_modules(e, GroupNorm32) for e in cond_encoders),
                  "unet": count_modules(unet, GroupNorm32),
                  "decode": count_modules(engine.first_stage_model.decoder, GroupNorm32)}
    gn_per_pass = {stage: sum(calls.values()) for stage, calls in gn_calls.items()}
    if gn_per_pass != gn_modules:
        raise RuntimeError(f"GroupNorm calls per pass {gn_per_pass} != modules {gn_modules}")
    per_clip = {"cond": 1, "unet": steps, "decode": 1}
    gn_sites = Counter()
    for stage, calls in gn_calls.items():
        for key, n in calls.items():
            gn_sites[key] += per_clip[stage] * n
    log("groupnorm_sites", per_pass=gn_per_pass, distinct_shapes=len(gn_sites))
    # The path's tensors are channels-last; K4 / K5 also take channels-first
    # ones (contiguous, and the time_stack view of a contiguous video), which
    # are held against the plain versions at the same shapes, 0 launches per
    # clip.
    gn_checked = Counter(gn_sites)
    for shape, _, eps, silu in list(gn_sites):
        gn_checked[(shape, "contiguous", eps, silu)] += 0
        if len(shape) == 5:
            b, c5, t, h, w = shape
            view = torch.empty(b, t, c5, h, w, device="meta").transpose(1, 2)
            gn_checked[(shape, memory_layout(view), eps, silu)] += 0

    gen = torch.Generator("cuda").manual_seed(SEED)
    stats = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "library_ms": None, "t_bytes": 0.0, "t_ops": 0.0, "per_clip": 0}
             for name in KERNELS}
    gn_ms = {}  # site label -> (K4 ms, plain ms) per call
    cases = itertools.chain(attention_mlp_cases(gen, steps), groupnorm_cases(gen, gn_checked))
    for name, label, n_clip, run, plain, library, nbytes, flops, peak in cases:
        out = run()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        err, err_abs = rel_l2(out, ref), max_abs(out, ref)
        (ms, host_ms), (plain_ms, plain_host_ms) = cuda_ms(run), cuda_ms(plain)
        lib_ms, lib_host_ms = cuda_ms(library) if library is not None else (None, None)
        b_ms, b_by = bound(nbytes, flops, peak)
        log("kernel", kernel=name, shape=label, per_clip=n_clip, rel_l2=err,
            max_abs_err=err_abs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, host_ms=host_ms, plain_host_ms=plain_host_ms,
            library_host_ms=lib_host_ms, card=smi)
        if not err <= KERNEL_TOL:
            raise RuntimeError(f"{name} {label}: relative L2 {err} > {KERNEL_TOL}")
        if name in ("fused_gn", "gn_stats") and rel_l2(run(), out) != 0.0:
            raise RuntimeError(f"{name} {label}: two calls differ (no atomics: must not)")
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err_abs)
        st["ms"] += n_clip * ms
        st["plain_ms"] += n_clip * plain_ms
        st["bound_ms"] += n_clip * b_ms
        st["t_bytes"] += n_clip * nbytes / HBM_BPS
        st["t_ops"] += n_clip * flops / peak
        st["per_clip"] += n_clip
        if lib_ms is not None:
            st["library_ms"] = (st["library_ms"] or 0.0) + n_clip * lib_ms
        if name == "fused_gn" and n_clip:
            gn_ms[label] = (ms, plain_ms)
        del out, ref, run, plain, library
    torch.cuda.empty_cache()
    by_stage = {stage: {"k4_ms": sum(n * gn_ms[site_label(k)][0] for k, n in calls.items()),
                        "plain_ms": sum(n * gn_ms[site_label(k)][1] for k, n in calls.items())}
                for stage, calls in gn_calls.items()}
    log("groupnorm_per_pass", **by_stage, card=smi)

    # Phase 5: the modules with the kernels on vs off, and timed.
    all_off = dict.fromkeys(KERNELS, False)
    gn_off = {"fused_gn": False, "gn_stats": False}
    with torch.no_grad():
        den_on, unet_s_on = wall_s(denoise)
        raw_on = network(x, torch.zeros(BT, device="cuda"), cond)
        dec_on, dec_s_on = wall_s(decode)
        cat_on = engine.apply_conditioner(batch)["concat"]
        with kernel_flags(**gn_off):
            _, unet_s_gn_off = wall_s(denoise)
            _, dec_s_gn_off = wall_s(decode)
        with kernel_flags(**all_off):
            den_off, unet_s_off = wall_s(denoise)
            raw_off = network(x, torch.zeros(BT, device="cuda"), cond)
            dec_off = decode()
            cat_off = engine.apply_conditioner(batch)["concat"]
    ab = {"denoiser_rel_l2": rel_l2(den_on, den_off), "unet_rel_l2": rel_l2(raw_on, raw_off),
          "decode_rel_l2": rel_l2(dec_on, dec_off), "concat_rel_l2": rel_l2(cat_on, cat_off)}
    log("ab", **ab, tol=AB_TOL, unet_out_std=float(raw_off.float().std()),
        unet_s={"on": unet_s_on, "gn_off": unet_s_gn_off, "all_off": unet_s_off},
        decode_s={"on": dec_s_on, "gn_off": dec_s_gn_off}, card=smi)
    if not all(v <= AB_TOL for v in ab.values()):
        raise RuntimeError(f"kernels on vs off: {ab} > {AB_TOL}")
    del den_on, den_off, raw_on, raw_off, dec_on, dec_off

    # Device time by kernel over one UNet evaluation and one decode, GroupNorm
    # kernels on and off; the idle share is against the unprofiled wall time.
    walls = {"unet": unet_s_on, "unet_gn_off": unet_s_gn_off, "decode": dec_s_on,
             "decode_gn_off": dec_s_gn_off}
    for what, wall in walls.items():
        with torch.no_grad(), kernel_flags(**(gn_off if what.endswith("gn_off") else {})):
            by_name, total = device_profile(denoise if what.startswith("unet") else decode)
        if total is None:
            log("profile", what=what, device_ms="not measured", card=smi)
            continue
        log("profile", what=what, device_ms=total, wall_ms=1e3 * wall,
            idle_share=1.0 - total / (1e3 * wall),
            groupnorm_kernels_ms=sum(ms for k, ms in by_name.items()
                                     if "group_norm" in k or "group_stats" in k),
            top=[[k[:90], ms] for k, ms in by_name.most_common(10)], card=smi)

    # Phase 6: three requests through the engine's entry point.
    expected = {"flash": count_modules(unet, BasicTransformerBlock) * steps,
                "tattn": count_modules(unet, VideoTransformerBlock) * steps,
                "fused_mlp": count_modules(unet, FeedForward) * steps,
                "fused_gn": gn_modules["cond"] + steps * gn_modules["unet"]
                + gn_modules["decode"],
                "gn_stats": stats["gn_stats"]["per_clip"]}
    clip_s = []
    torch.cuda.reset_peak_memory_stats()
    for fn in KERNELS.values():
        fn.launches = 0
    for request in range(3):
        gen = torch.Generator("cuda").manual_seed(SEED + 10 + request)
        batch = random_batch(gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = engine.sample_video(batch, generator=gen, decoding_t=T)["sampled_video"]
        torch.cuda.synchronize()
        clip_s.append(time.perf_counter() - t0)
        if tuple(frames.shape) != (T, H, W, 3):
            raise RuntimeError(f"frames shape {tuple(frames.shape)}")
        if not (torch.isfinite(frames).all() and frames.min() >= 0 and frames.max() <= 1):
            raise RuntimeError("frames not finite in [0, 1]")
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    log("slice", clip_seconds=clip_s, frames_per_s=2 * T / (clip_s[1] + clip_s[2]),
        peak_mem_bytes=torch.cuda.max_memory_allocated(), launches=launches,
        expected_per_clip=expected, frames_std=float(frames.std()), card=smi)
    for name, n in launches.items():
        if n != 3 * expected[name] or expected[name] == 0:
            raise RuntimeError(f"{name}: {n} launches over 3 clips, expected "
                               f"3 x {expected[name]}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"], "ms": stats[name]["ms"],
         "plain_ms": stats[name]["plain_ms"], "bound_ms": stats[name]["bound_ms"],
         "bound_by": "bytes" if stats[name]["t_bytes"] >= stats[name]["t_ops"]
         else "operations",
         "library_ms": stats[name]["library_ms"]}
        for name in KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

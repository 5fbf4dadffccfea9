"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero without
the final `ok` line):
  1. device   - require CUDA; print nvidia-smi's name and power limit.
  2. build    - compile gcd_tpu_torch/csrc/*.cu with nvcc (sm_90a).
  3. kernels  - each CUDA kernel (K1 flash attention, K2 temporal attention,
                K3 fused GEGLU MLP) against its plain PyTorch version at every
                main-path shape, bf16, relative L2 <= 1e-2; CUDA-event times.
  4. unet_ab  - one CFG-doubled flagship-UNet evaluation (configs/
                infer_kubric.yaml, random bf16 weights, std 0.02 on every
                leaf) with the kernels on vs all off; relative L2 <= 2e-2.
  5. slice    - three 14-frame 384x256 clips through
                DiffusionEngine.sample_video_from_cond (25 Euler-EDM steps,
                per-frame CFG up to 1.5, one 14-frame decode), distinct noise
                seeds; checks the frames and each kernel's launch count.
Then the kernel JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
T, H, W = 14, 256, 384
HL, WL = H // 8, W // 8
BT = 2 * T  # CFG-doubled
SEED = 0
KERNEL_TOL = 1e-2   # relative L2, the bf16 kernel gate of bench.py:211
UNET_AB_TOL = 2e-2  # relative L2, whole UNet evaluation, kernels on vs off

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
}


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def cuda_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases(gen: torch.Generator):
    """(kernel, label, sites per UNet evaluation, kernel call, plain call)."""
    from gcd_tpu_torch.ops import (flash_attention, flash_attention_plain, geglu_mlp,
                                   geglu_mlp_plain, temporal_attention,
                                   temporal_attention_plain)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    for name, s, c, blocks in LEVELS:
        heads = c // 64
        q, k, v = randn(BT, s, c), randn(BT, s, c), randn(BT, s, c)
        yield ("flash", f"{name} ({BT},{s},{heads}x64)", blocks,
               lambda q=q, k=k, v=v, h=heads: flash_attention(q, k, v, h),
               lambda q=q, k=k, v=v, h=heads: flash_attention_plain(q, k, v, h))
        yield ("tattn", f"{name} ({BT},{s},{c}) T={T}", blocks,
               lambda q=q, k=k, v=v, h=heads: temporal_attention(q, k, v, T, h),
               lambda q=q, k=k, v=v, h=heads: temporal_attention_plain(q, k, v, T, h))
        x = randn(BT * s, c)
        w1, b1 = randn(8 * c, c, std=c ** -0.5), randn(8 * c, std=0.1)
        w2, b2 = randn(c, 4 * c, std=(4 * c) ** -0.5), randn(c, std=0.1)
        yield ("fused_mlp", f"{name} M={BT * s} C={c} I={4 * c}", 3 * blocks,
               lambda a=(x, w1, b1, w2, b2): geglu_mlp(*a),
               lambda a=(x, w1, b1, w2, b2): geglu_mlp_plain(*a))


def build_engine():
    from gcd_tpu_torch.utils.config import instantiate_from_config, load_config

    cfg = load_config(os.path.join(REPO, "configs", "infer_kubric.yaml"))
    with torch.device("meta"):
        engine = instantiate_from_config(cfg["model"]).to(torch.bfloat16)
    engine = engine.to_empty(device="cuda").eval()
    gen = torch.Generator("cuda").manual_seed(SEED + 1)
    with torch.no_grad():
        for p in engine.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    return engine


def conditioning(gen: torch.Generator):
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    c = {"crossattn": randn(T, 1, 1024), "vector": randn(T, 896),
         "concat": randn(T, HL, WL, 4)}
    # The unconditional branch zeroes the image embeddings, as the JAX engine's
    # force_uc_zero_embeddings does.
    uc = {"crossattn": torch.zeros_like(c["crossattn"]), "vector": c["vector"],
          "concat": torch.zeros_like(c["concat"])}
    return c, uc


def expected_launches_per_eval(unet) -> dict:
    from gcd_tpu_torch.models.attention import BasicTransformerBlock
    from gcd_tpu_torch.models.layers import FeedForward
    from gcd_tpu_torch.models.video_attention import VideoTransformerBlock

    mods = list(unet.modules())
    return {"flash": sum(isinstance(m, BasicTransformerBlock) for m in mods),
            "tattn": sum(isinstance(m, VideoTransformerBlock) for m in mods),
            "fused_mlp": sum(isinstance(m, FeedForward) for m in mods)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    sys.path.insert(0, REPO)
    from gcd_tpu_torch.ops import KERNELS, _native, kernel_flags

    t0 = time.perf_counter()
    _, ptxas = _native.build()
    _native.library()
    log("build", seconds=round(time.perf_counter() - t0, 3),
        ptxas=[line.split(": ", 1)[-1] for line in ptxas.splitlines() if "Used" in line])

    # Phase 3: every kernel against its plain version at the main-path shapes.
    gen = torch.Generator("cuda").manual_seed(SEED)
    stats = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for name in KERNELS}
    for name, label, sites, run, plain in kernel_cases(gen):
        out = run()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        err, max_abs = rel_l2(out, ref), float((out.float() - ref.float()).abs().max())
        ms, plain_ms = cuda_ms(run), cuda_ms(plain)
        log("kernel", kernel=name, shape=label, rel_l2=err, max_abs_err=max_abs,
            ms=ms, plain_ms=plain_ms, card=smi)
        if not err <= KERNEL_TOL:
            raise RuntimeError(f"{name} {label}: relative L2 {err} > {KERNEL_TOL}")
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], max_abs)
        st["ms"] += sites * ms
        st["plain_ms"] += sites * plain_ms
        del out, ref
    torch.cuda.empty_cache()

    engine = build_engine()
    unet = engine.model.diffusion_model
    per_eval = expected_launches_per_eval(unet)

    # Phase 4: one CFG-doubled denoiser evaluation, kernels on vs off.
    gen = torch.Generator("cuda").manual_seed(SEED + 2)
    c, uc = conditioning(gen)
    cond = {k: torch.cat([uc[k], c[k]]) for k in c}
    cond["concat"] = cond["concat"].permute(0, 3, 1, 2)
    x = torch.randn(BT, 4, HL, WL, generator=gen, device="cuda")
    sigma = torch.full((BT,), 1.0, device="cuda")
    ioi = torch.zeros(2, T, device="cuda")

    def network(xin, c_noise, cc):
        return engine.network_fn(xin, c_noise, cc, T, ioi)

    with torch.no_grad():
        net_on = engine.denoiser(network, x, sigma, cond)
        raw_on = network(x, torch.full((BT,), 0.0, device="cuda"), cond)
        with kernel_flags(flash=False, tattn=False, fused_mlp=False):
            net_off = engine.denoiser(network, x, sigma, cond)
            raw_off = network(x, torch.full((BT,), 0.0, device="cuda"), cond)
    torch.cuda.synchronize()
    ab = {"denoiser_rel_l2": rel_l2(net_on, net_off), "unet_rel_l2": rel_l2(raw_on, raw_off),
          "unet_out_std": float(raw_off.float().std())}
    log("unet_ab", **ab, tol=UNET_AB_TOL, card=smi)
    if not (ab["denoiser_rel_l2"] <= UNET_AB_TOL and ab["unet_rel_l2"] <= UNET_AB_TOL):
        raise RuntimeError(f"UNet kernels-on vs off: {ab} > {UNET_AB_TOL}")
    del net_on, net_off, raw_on, raw_off

    # Phase 5: three requests through the engine's entry point.
    steps = engine.sampler.num_steps
    expected = {k: v * steps for k, v in per_eval.items()}
    clip_s = []
    torch.cuda.reset_peak_memory_stats()
    for fn in KERNELS.values():
        fn.launches = 0
    for request in range(3):
        gen = torch.Generator("cuda").manual_seed(SEED + 10 + request)
        c, uc = conditioning(gen)
        noise = torch.randn(T, HL, WL, 4, generator=gen, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = engine.sample_video_from_cond(c, uc, noise, decoding_t=T)
        torch.cuda.synchronize()
        clip_s.append(time.perf_counter() - t0)
        if tuple(frames.shape) != (T, H, W, 3):
            raise RuntimeError(f"frames shape {tuple(frames.shape)}")
        if not (torch.isfinite(frames).all() and frames.min() >= 0 and frames.max() <= 1):
            raise RuntimeError("frames not finite in [0, 1]")
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    log("slice", clip_seconds=clip_s, frames_per_s=2 * T / (clip_s[1] + clip_s[2]),
        peak_mem_bytes=peak, launches=launches, expected_per_clip=expected,
        frames_std=float(frames.std()), card=smi)
    for name, n in launches.items():
        if n != 3 * expected[name] or expected[name] == 0:
            raise RuntimeError(f"{name}: {n} launches over 3 clips, expected "
                               f"3 x {expected[name]}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
        for name in KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Host, CUDA-event and device time of the port's K1-K7 wrappers, two source
trees compared.

    python3 scripts/torch_host_ab.py TREE_A TREE_B

Each tree is a checkout holding `gcd_tpu_torch/` (for example the parent
commit unpacked with `git archive` into a git-ignored directory). The trees
run in the order A, B, B, A, each in a fresh process that builds the tree's
kernels and imports only that tree. Each prints one JSON line: per shape,
the host time to enqueue one wrapper call (`host_ms`, the mean of 400 calls
under torch.no_grad), the CUDA-event time per call (`event_ms`, which is
the host's time where the host is slower than the kernel) and the device
time per call (`device_ms`, every kernel the call launches, from
torch.profiler over 20 calls). The shapes are at one clip after CFG
(N = 28): K7's 4x6, 8x12, ds1 and ds2 ResBlock chains, K1's ds1, ds2 and
ds4 attentions, K2's temporal attentions at its four levels (T = 14) with
the sum over a clip's 400 calls (125 / 125 / 125 / 25) and at ds1 for the
served batch (B*T = 56), K3's four feed-forwards; K5 and K4 (with SiLU; K4 runs K5
inside it where its site takes the split path) at every channels-last
GroupNorm shape of the clip (K5_SITES), with the sum over a clip's calls of
each time; K6 at the training step's four attention shapes (B*T = 28),
with the sum over a step's calls; and, where
the tree has the per-stream scratch, the host time of getting K3's h buffer
at the served ds1 shape from it against a torch.empty of that size. The
first line is nvidia-smi's name and power limit. Needs one CUDA card.
"""

import json
import os
import subprocess
import sys
import time


# K5's channels-last shapes on the clip's path, (N, C, *spatial), and its
# calls a clip at each (chip_smoke.py's phase-4 site counts: K4's split path,
# 1605 calls; K7's 1100 calls of K5 run inside K7 and are timed with it):
# the decoder's and the time_stack views' planes, then the UNet's.
K5_SITES = [((1, 128, 14, 256, 384), 6), ((1, 256, 14, 128, 192), 6), ((1, 512, 14, 32, 48), 10),
            ((1, 512, 14, 64, 96), 6), ((2, 320, 14, 32, 48), 250), ((2, 640, 14, 16, 24), 250),
            ((2, 1280, 14, 4, 6), 350), ((2, 1280, 14, 8, 12), 250), ((14, 128, 128, 192), 1),
            ((14, 128, 256, 384), 10), ((14, 256, 64, 96), 1), ((14, 256, 128, 192), 8),
            ((14, 256, 256, 384), 1), ((14, 512, 32, 48), 21), ((14, 512, 64, 96), 9),
            ((14, 512, 128, 192), 1), ((28, 320, 32, 48), 150), ((28, 640, 16, 24), 125),
            ((28, 1280, 4, 6), 25), ((28, 1280, 8, 12), 125)]


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from torch.profiler import ProfilerActivity, profile

    from gcd_tpu_torch.ops import (_native, flash_attention, flash_attention_bwd, geglu_mlp,
                                   gn_silu_conv3x3, group_norm, group_stats,
                                   temporal_attention)

    if not _native.__file__.startswith(root):
        raise RuntimeError(f"imported {_native.__file__}, not the tree {root}")
    _native.library()
    gen = torch.Generator("cuda").manual_seed(0)

    def randn(*shape, std=1.0, mean=0.0):
        t = torch.randn(*shape, generator=gen, device="cuda")
        return (mean + std * t).to(torch.bfloat16)

    def timed(fn, calls=400):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = 1e3 * (time.perf_counter() - t0) / calls
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        device = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / 20
        return {"host_ms": host, "event_ms": start.elapsed_time(end) / calls,
                "device_ms": device}

    def host_ms(fn, calls=2000):
        for _ in range(20):
            fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return 1e3 * (time.perf_counter() - t0) / calls

    result = {"tree": root}
    fmt = torch.channels_last
    with torch.no_grad():
        for n, c, h, w, f in [(28, 1280, 4, 6, 1280), (28, 1280, 8, 12, 1280),
                              (28, 320, 32, 48, 320), (28, 640, 16, 24, 640)]:
            x = randn(n, c, h, w).contiguous(memory_format=fmt)
            args = (x, randn(c, std=0.1, mean=1.0), randn(c, std=0.1),
                    randn(f, c, 3, 3, std=(9 * c) ** -0.5).contiguous(memory_format=fmt),
                    randn(f, std=0.1))
            result[f"K7 ({n},{c},{h},{w})->{f}"] = timed(lambda: gn_silu_conv3x3(*args))
        for b, s, heads in [(28, 1536, 5), (28, 384, 10), (28, 96, 20)]:
            q, k, v = (randn(b, s, heads * 64) for _ in range(3))
            result[f"K1 ({b},{s},{heads}x64)"] = timed(
                lambda: flash_attention(q, k, v, heads))
        # K2 at (B*T, S, C), T = 14, heads of 64: its calls a clip at each
        # level (5 time_stack blocks an evaluation at ds1, ds2, ds4, 1 at mid,
        # 25 evaluations), then ds1 at the served batch (no calls a clip).
        k2 = dict.fromkeys(("host_ms", "event_ms", "device_ms"), 0.0)
        for bt, s, c, per_clip in [(28, 1536, 320, 125), (28, 384, 640, 125),
                                   (28, 96, 1280, 125), (28, 24, 1280, 25), (56, 1536, 320, 0)]:
            q, k, v = (randn(bt, s, c) for _ in range(3))
            key = f"K2 ({bt},{s},{c}) T=14"
            result[key] = timed(lambda: temporal_attention(q, k, v, 14, c // 64))
            for name in k2:
                k2[name] += per_clip * result[key][name]
        result["K2 per clip"] = k2
        for m, c in [(43008, 320), (10752, 640), (2688, 1280), (672, 1280)]:
            args = (randn(m, c), randn(8 * c, c, std=c ** -0.5), randn(8 * c, std=0.1),
                    randn(c, 4 * c, std=(4 * c) ** -0.5), randn(c, std=0.1))
            result[f"K3 M={m} C={c}"] = timed(lambda: geglu_mlp(*args), calls=100)
        k5 = dict.fromkeys(("host_ms", "event_ms", "device_ms"), 0.0)
        k4 = dict(k5)
        for shape, per_clip in K5_SITES:
            c = shape[1]
            x = randn(*shape, std=2.0, mean=0.5).contiguous(
                memory_format=torch.channels_last if len(shape) == 4 else torch.channels_last_3d)
            wt, bs = randn(c, std=0.1, mean=1.0), randn(c, std=0.1)
            result[f"K5 {shape}"] = timed(lambda: group_stats(x, 32), calls=100)
            result[f"K4 {shape}"] = timed(lambda: group_norm(x, wt, bs, 32, 1e-5, True),
                                          calls=100)
            for key in k5:
                k5[key] += per_clip * result[f"K5 {shape}"][key]
                k4[key] += per_clip * result[f"K4 {shape}"][key]
            del x
        result["K5 per clip, K4's sites"] = k5
        result["K4 per clip"] = k4
        # K6 at the training step's shapes: (B*T, S, heads), calls a step.
        k6 = dict.fromkeys(("host_ms", "event_ms", "device_ms"), 0.0)
        for b, s, heads, per_step in [(28, 1536, 5, 5), (28, 384, 10, 5), (28, 96, 20, 5),
                                      (28, 24, 20, 1)]:
            q, k, v, g = (randn(b, s, heads * 64) for _ in range(4))
            result[f"K6 ({b},{s},{heads}x64)"] = timed(
                lambda: flash_attention_bwd(q, k, v, g, heads), calls=50)
            for key in k6:
                k6[key] += per_step * result[f"K6 ({b},{s},{heads}x64)"][key]
        result["K6 per step"] = k6
        # K3's h buffer at the served ds1 shape (M = 86016, I = 1280): the
        # host time of the per-stream cache's lookup against a torch.empty
        # of the same size from the caching allocator.
        if hasattr(_native, "stream_scratch"):
            numel = 86016 * 1280
            result["K3 h buffer, served ds1"] = {
                "stream_scratch_host_ms": host_ms(
                    lambda: _native.stream_scratch("geglu_h", numel, torch.bfloat16)),
                "empty_host_ms": host_ms(
                    lambda: torch.empty(numel, dtype=torch.bfloat16, device="cuda"))}
    return result


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = sys.argv[1:]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for tree in (a, b, b, a):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", tree],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

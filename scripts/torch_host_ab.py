"""Host time of the port's K7 and K1 wrappers, two source trees compared.

    python3 scripts/torch_host_ab.py TREE_A TREE_B

Each tree is a checkout holding `gcd_tpu_torch/` (for example the parent
commit unpacked with `git archive` into a git-ignored directory). The trees
run in the order A, B, B, A, each in a fresh process that builds the tree's
kernels and imports only that tree. Each prints one JSON line: per shape,
the host time to enqueue one wrapper call (`host_ms`, the mean of 400 calls
under torch.no_grad) and the CUDA-event time per call (`event_ms`, which is
the host's time where the host is slower than the kernel). The shapes are
K7's 4x6, ds1 and ds2 ResBlock chains and K1's ds1, ds2 and ds4 attentions
at one clip after CFG (N = 28). The first line is nvidia-smi's name and
power limit. Needs one CUDA card.
"""

import json
import os
import subprocess
import sys
import time


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from gcd_tpu_torch.ops import _native, flash_attention, gn_silu_conv3x3

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
        return {"host_ms": host, "event_ms": start.elapsed_time(end) / calls}

    result = {"tree": root}
    fmt = torch.channels_last
    with torch.no_grad():
        for n, c, h, w, f in [(28, 1280, 4, 6, 1280), (28, 320, 32, 48, 320),
                              (28, 640, 16, 24, 640)]:
            x = randn(n, c, h, w).contiguous(memory_format=fmt)
            args = (x, randn(c, std=0.1, mean=1.0), randn(c, std=0.1),
                    randn(f, c, 3, 3, std=(9 * c) ** -0.5).contiguous(memory_format=fmt),
                    randn(f, std=0.1))
            result[f"K7 ({n},{c},{h},{w})->{f}"] = timed(lambda: gn_silu_conv3x3(*args))
        for b, s, heads in [(28, 1536, 5), (28, 384, 10), (28, 96, 20)]:
            q, k, v = (randn(b, s, heads * 64) for _ in range(3))
            result[f"K1 ({b},{s},{heads}x64)"] = timed(
                lambda: flash_attention(q, k, v, heads))
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

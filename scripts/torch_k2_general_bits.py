"""K2's general family from several source trees, compared bit for bit and
timed on one card.

    python3 scripts/torch_k2_general_bits.py TREE_A TREE_B [TREE ...]

Each tree is a checkout holding `gcd_tpu_torch/` (for example the parent
commit unpacked with `git archive` into a git-ignored directory). Each runs
in a fresh process, in the order given (A B B A compares two trees in
turns), that builds the tree's kernels, imports only that tree, and on the
same seeded inputs at `chip_smoke.py` phase 4's general-family shapes
hashes K2's output (SHA-256 of the bf16 bits) and times it by CUDA events
(mean of 20 calls after 3 warm-up calls). The shapes: one clip with CFG
(B*T = 2 T) at T = 33, 64 and 100 at the UNet's four levels (heads of 64),
a ragged S at ds1 and T = 64, the `num_heads: 8` UNet's D = 40 at ds1 and
160 at ds4 (T = 14), the VAE's one head of 512 at T = 25 and 32, and two
boundary cases: ds1 at T = 128 and one head of 1024 at T = 33. The first
line is nvidia-smi's name and power limit, then one JSON line a tree, then
{"equal": {shape: bool}} (every tree against the first). Needs one CUDA
card.
"""

import hashlib
import json
import os
import subprocess
import sys

LEVELS = [("ds1", 1536, 320), ("ds2", 384, 640), ("ds4", 96, 1280), ("mid", 24, 1280)]
# (label, B*T, S, C, T, heads)
SHAPES = ([(f"{name} T={t}", 2 * t, s, c, t, c // 64) for t in (33, 64, 100)
           for name, s, c in LEVELS]
          + [("ds1 ragged S T=64", 128, 1531, 320, 64, 5),
             ("ds1 8x40 T=14", 28, 1536, 320, 14, 8),
             ("ds4 8x160 T=14", 28, 96, 1280, 14, 8),
             ("1x512 T=25", 50, 1536, 512, 25, 1),
             ("1x512 T=32", 64, 1536, 512, 32, 1),
             ("ds1 T=128", 256, 1536, 320, 128, 5),
             ("1x1024 T=33", 66, 1536, 1024, 33, 1)])
WARMUP, CALLS = 3, 20


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from gcd_tpu_torch.ops import _native, temporal_attention

    if not _native.__file__.startswith(root):
        raise RuntimeError(f"imported {_native.__file__}, not the tree {root}")
    _native.library()
    gen = torch.Generator("cuda").manual_seed(0)
    sha, ms = {}, {}
    with torch.no_grad():
        for label, bt, s, c, t, heads in SHAPES:
            q, k, v = (torch.randn(bt, s, c, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(3))
            out = temporal_attention(q, k, v, t, heads)
            sha[label] = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            for _ in range(WARMUP):
                temporal_attention(q, k, v, t, heads)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS):
                temporal_attention(q, k, v, t, heads)
            end.record()
            torch.cuda.synchronize()
            ms[label] = start.elapsed_time(end) / CALLS
            del q, k, v, out
    return {"sha256": sha, "event_ms": ms}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    results = []
    for tree in sys.argv[1:]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", tree],
                             capture_output=True, text=True, check=True).stdout
        results.append(json.loads(out.strip().splitlines()[-1]))
        print(json.dumps({"tree": tree, **results[-1]}), flush=True)
    first = results[0]["sha256"]
    equal = {k: all(r["sha256"][k] == first[k] for r in results[1:]) for k in first}
    print(json.dumps({"equal": equal}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

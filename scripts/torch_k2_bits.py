"""K2's outputs from two source trees, compared bit for bit.

    python3 scripts/torch_k2_bits.py TREE_A TREE_B

Each tree is a checkout holding `gcd_tpu_torch/` (for example the parent
commit unpacked with `git archive` into a git-ignored directory). Each runs
in a fresh process that builds the tree's kernels and imports only that
tree, and hashes K2's output (SHA-256 of the bf16 bits) on the same seeded
inputs at the UNet's shapes: its four levels at one clip after CFG (B*T =
28, T = 14, heads of 64), the plain steps' ds1 (B*T = 14) and the served
batch's ds1 (B*T = 56). The first line is nvidia-smi's name and power
limit, then one JSON line a tree, then {"equal": {shape: bool}}. Needs one
CUDA card.
"""

import hashlib
import json
import os
import subprocess
import sys

SHAPES = [(28, 1536, 320), (28, 384, 640), (28, 96, 1280), (28, 24, 1280), (14, 1536, 320),
          (56, 1536, 320)]


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from gcd_tpu_torch.ops import _native, temporal_attention

    if not _native.__file__.startswith(root):
        raise RuntimeError(f"imported {_native.__file__}, not the tree {root}")
    _native.library()
    gen = torch.Generator("cuda").manual_seed(0)
    result = {}
    with torch.no_grad():
        for bt, s, c in SHAPES:
            q, k, v = (torch.randn(bt, s, c, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(3))
            out = temporal_attention(q, k, v, 14, c // 64)
            bits = out.view(torch.int16).cpu().numpy().tobytes()
            result[f"({bt},{s},{c})"] = hashlib.sha256(bits).hexdigest()
    return result


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    hashes = []
    for tree in sys.argv[1:]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", tree],
                             capture_output=True, text=True, check=True).stdout
        hashes.append(json.loads(out.strip().splitlines()[-1]))
        print(json.dumps({"tree": tree, "sha256": hashes[-1]}), flush=True)
    print(json.dumps({"equal": {k: hashes[0][k] == hashes[1][k] for k in hashes[0]}}),
          flush=True)
    return 0 if all(hashes[0][k] == hashes[1][k] for k in hashes[0]) else 1


if __name__ == "__main__":
    sys.exit(main())

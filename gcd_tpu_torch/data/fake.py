"""Synthetic Kubric-4D roots at the reference converter's on-disk layout
(port of the Kubric half of scripts/make_fake_data.py:29-66), so that the
training entry runs where the real dataset is not.

    make_kubric_root(root)                                   # the tiny test root
    make_kubric_root(root, n_frames=16, n_views=16, n_points=576 * 384)  # full size

Each frame file holds a rotating Gaussian blob of points around the look-at
target (0, 0, 1) with random colours, `n_views` x `n_points` points: the
converter merges 16 views of 576 x 384 pixels, 3,538,944 points a frame.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gcd_tpu_torch.data import common


def make_kubric_root(root: str, n_scenes: int = 1, n_frames: int = 20, n_views: int = 4,
                     n_points: int = 3000, seed: int = 0) -> None:
    """Write {root}/data/scnNNNNN/scnNNNNN_p0_v4.json and
    {root}/pcl/scnNNNNN/pcl_rgb_segm_TTTTT.pt, from np.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    for s in range(n_scenes):
        scn = f"scn{s:05d}"
        scene_data = os.path.join(root, "data", scn)
        scene_pcl = os.path.join(root, "pcl", scn)
        os.makedirs(scene_data, exist_ok=True)
        os.makedirs(scene_pcl, exist_ok=True)
        metadata = {
            "scene": {"num_frames": n_frames},
            "camera": {
                "quaternions": [[1.0, 0.0, 0.0, 0.0]] * n_frames,
                "positions": [[0.0, -14.0, 2.0]] * n_frames,
                "K": [[0.875, 0.0, 0.5], [0.0, 1.3125, 0.5], [0.0, 0.0, 1.0]],
            },
        }
        common.save_json(metadata, os.path.join(scene_data, f"{scn}_p0_v4.json"))
        for t in range(n_frames):
            theta = t * 0.1
            base = rng.normal(size=(n_views, n_points, 3)) * 1.5
            base[..., 2] += 1.0
            rot = np.array([[np.cos(theta), -np.sin(theta), 0],
                            [np.sin(theta), np.cos(theta), 0],
                            [0, 0, 1.0]])
            xyz = (base @ rot.T).astype(np.float16)
            rgb = rng.integers(0, 255, (n_views, n_points, 3), dtype=np.uint8)
            segm = rng.integers(0, 10, (n_views, n_points, 3), dtype=np.uint8)
            torch.save([torch.from_numpy(xyz), torch.from_numpy(rgb), torch.from_numpy(segm)],
                       os.path.join(scene_pcl, f"pcl_rgb_segm_{t:05d}.pt"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="write a synthetic Kubric-4D root")
    ap.add_argument("root")
    ap.add_argument("--scenes", type=int, default=1)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--points", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    make_kubric_root(args.root, args.scenes, args.frames, args.views, args.points, args.seed)
    print(f"kubric fake root: {args.root} ({args.scenes} scenes x {args.frames} frames)")


if __name__ == "__main__":
    main()

"""Synthetic Kubric-4D and ParallelDomain-4D roots at the reference
converters' on-disk layouts (port of scripts/make_fake_data.py:29-135), so
that the training entry runs where the real datasets are not.

    make_kubric_root(root)                                   # the tiny test root
    make_kubric_root(root, n_frames=16, n_views=16, n_points=576 * 384)  # full size
    make_pardom_root(root)                                   # the tiny test root
    make_pardom_root(root, n_points=640 * 480, frame_hw=(480, 640))      # full size

A Kubric frame file holds a rotating Gaussian blob of points around the
look-at target (0, 0, 1) with random colours, `n_views` x `n_points` points:
the converter merges 16 views of 576 x 384 pixels, 3,538,944 points a frame.
A ParallelDomain frame file holds a Gaussian blob above the ground in 19
views (16 surround cameras, 3 ego cameras) of `n_points` points each: the
converter unprojects every pixel of 19 views of 640 x 480, 5,836,800 points
a frame. Its ego frames are random PNGs, written with all five row filters.

    python -m gcd_tpu_torch.data.fake /tmp/kubric_fake
    python -m gcd_tpu_torch.data.fake --pardom /tmp/pd_fake
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gcd_tpu_torch.data import common
from gcd_tpu_torch.data.png import write_png
from gcd_tpu_torch.diffusion.loss import PERSON_RGB, VEHICLE_RGB

PARDOM_VIEWS = 19  # 16 surround ("magic") cameras + 3 ego cameras


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


def pardom_ontology_items():
    """The synthetic ontology: ids 0-29 with the script's colours."""
    return [{"id": i, "color": {"r": (i * 37) % 256, "g": (i * 91) % 256, "b": (i * 53) % 256}}
            for i in range(30)]


def class_ontology_items():
    """pardom_ontology_items with ids 1-14 in the colours of the classes the
    loss weighs (diffusion/loss.py's PERSON_RGB, then VEHICLE_RGB), as the
    real ParallelDomain ontology has them."""
    items = pardom_ontology_items()
    for i, rgb in enumerate(PERSON_RGB + VEHICLE_RGB, start=1):
        items[i] = {"id": i, "color": dict(zip("rgb", rgb))}
    return items


def _pardom_calibration():
    def quat(w, x, y, z):
        return {"qw": w, "qx": x, "qy": y, "qz": z}

    names, intr, extr = [], [], []
    for i in range(16):
        names.append(f"camera{i}")
        intr.append({"fx": 400.0, "fy": 400.0, "cx": 320.0, "cy": 240.0})
        extr.append({"rotation": quat(1.0, 0, 0, 0),
                     "translation": {"x": -42.0, "y": 0.0, "z": 6.0}})
    for nm in ("yaw-0", "yaw-60", "yaw-neg-60"):
        names.append(nm)
        intr.append({"fx": 500.0, "fy": 500.0, "cx": 320.0, "cy": 240.0})
        extr.append({"rotation": quat(1.0, 0, 0, 0),
                     "translation": {"x": 1.6, "y": 0.0, "z": 1.55}})
    return {"names": names, "intrinsics": intr, "extrinsics": extr}


def _write_frame_png(path: str, img: np.ndarray) -> None:
    """An RGB frame with row y filtered by type y % 5 (None, Sub, Up,
    Average, Paeth), so that a reader must undo all five."""
    write_png(path, img, filters=np.arange(img.shape[0]) % 5)


def make_pardom_root(root: str, n_scenes: int = 1, n_frames: int = 50, n_points: int = 1500,
                     seed: int = 0, frame_hw=(48, 64), magic_frames: bool = False,
                     ontology_items=None, segm_cell: float = 0.0) -> None:
    """Write {root}/data/scene_NNNNNN/{calibration,ontology}/*.json,
    rgb/yaw-0/{t*10+5:018d}.png and {root}/pcl/scene_NNNNNN/
    pcl_rgb_segm_{t*10+5:06d}.pt for each scene, and
    {root}/data/pardom_datasplit.json, from np.random.default_rng(seed) in
    the script's order (with the default arguments, the script's arrays).

    frame_hw: the ego frames' (height, width); n_points: points a view;
    magic_frames: also RGB frames of the 16 camera{i} views (from
    default_rng((seed, 1))), which the magic_random / magic_opposite modes
    read; ontology_items: the ontology's [{"id", "color": {"r", "g", "b"}}]
    (default pardom_ontology_items()); segm_cell: 0 keeps the script's
    random class id a point, > 0 gives every point the id of its (x, y) cell
    of that size in metres, cycling over the ontology's ids, so that a
    rendered class covers whole regions."""
    rng = np.random.default_rng(seed)
    magic_rng = np.random.default_rng((seed, 1))
    items = pardom_ontology_items() if ontology_items is None else list(ontology_items)
    item_ids = np.array([it["id"] for it in items], dtype=np.int64)
    h, w = frame_hw
    scene_names = []
    for s in range(n_scenes):
        scn = f"scene_{s:06d}"
        scene_names.append(scn)
        scene = os.path.join(root, "data", scn)
        pcl_scene = os.path.join(root, "pcl", scn)
        for d in ("calibration", "ontology", os.path.join("rgb", "yaw-0")):
            os.makedirs(os.path.join(scene, d), exist_ok=True)
        os.makedirs(pcl_scene, exist_ok=True)
        common.save_json(_pardom_calibration(), os.path.join(scene, "calibration",
                                                             "calib.json"))
        common.save_json({"items": items}, os.path.join(scene, "ontology", "onto.json"))
        for t in range(n_frames):
            name = f"{t * 10 + 5:018d}.png"
            _write_frame_png(os.path.join(scene, "rgb", "yaw-0", name),
                             rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
            xyz = rng.normal(size=(PARDOM_VIEWS, n_points, 3)).astype(np.float16) * 6
            xyz[..., 2] = np.abs(xyz[..., 2])  # above the ground
            rgb = rng.integers(0, 255, (PARDOM_VIEWS, n_points, 3), dtype=np.uint8)
            segm = rng.integers(0, 30, (PARDOM_VIEWS, n_points, 1), dtype=np.uint8)
            if segm_cell > 0:
                cell = np.floor(xyz[..., 0:2].astype(np.float32) / segm_cell).astype(np.int64)
                segm = item_ids[(cell[..., 0] + 3 * cell[..., 1]) % len(item_ids)]
                segm = segm[..., None].astype(np.uint8)
            tag = np.zeros((PARDOM_VIEWS, n_points, 1), dtype=np.uint8)
            torch.save([torch.from_numpy(xyz), torch.from_numpy(rgb), torch.from_numpy(segm),
                        torch.from_numpy(tag)],
                       os.path.join(pcl_scene, f"pcl_rgb_segm_{t * 10 + 5:06d}.pt"))
            if magic_frames:
                for i in range(16):
                    cam_dir = os.path.join(scene, "rgb", f"camera{i}")
                    os.makedirs(cam_dir, exist_ok=True)
                    _write_frame_png(os.path.join(cam_dir, name),
                                     magic_rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    common.save_json({"train": scene_names, "val": scene_names, "test": scene_names},
                     os.path.join(root, "data", "pardom_datasplit.json"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="write a synthetic Kubric-4D root, or with "
                                 "--pardom a ParallelDomain-4D one")
    ap.add_argument("root")
    ap.add_argument("--pardom", action="store_true", help="a ParallelDomain-4D root")
    ap.add_argument("--scenes", type=int, default=1)
    ap.add_argument("--frames", type=int, default=0,
                    help="frames a scene (0: 20 for Kubric, 50 for ParallelDomain)")
    ap.add_argument("--views", type=int, default=4, help="Kubric: views a frame")
    ap.add_argument("--points", type=int, default=0,
                    help="points a view (0: 3000 for Kubric, 1500 for ParallelDomain)")
    ap.add_argument("--height", type=int, default=48, help="ParallelDomain: frame height")
    ap.add_argument("--width", type=int, default=64, help="ParallelDomain: frame width")
    ap.add_argument("--magic_frames", action="store_true",
                    help="ParallelDomain: RGB frames of the 16 surround cameras too")
    ap.add_argument("--segm_cell", type=float, default=0.0,
                    help="ParallelDomain: class ids by (x, y) cell of this size (m)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.pardom:
        frames = args.frames or 50
        make_pardom_root(args.root, args.scenes, frames, args.points or 1500, args.seed,
                         (args.height, args.width), args.magic_frames,
                         segm_cell=args.segm_cell)
        print(f"pardom fake root: {args.root} ({args.scenes} scenes x {frames} frames)")
        return
    frames = args.frames or 20
    make_kubric_root(args.root, args.scenes, frames, args.views, args.points or 3000,
                     args.seed)
    print(f"kubric fake root: {args.root} ({args.scenes} scenes x {frames} frames)")


if __name__ == "__main__":
    main()

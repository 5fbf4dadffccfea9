"""Kubric-4D training pairs rendered on the fly from merged point clouds
(port of gcd_tpu/data/kubric.py:24-449).

An item picks a scene, a clip of `model_frames` frames, a start pose and a
camera move from np.random.default_rng((seed, idx, retry)), renders the
clip's clouds along the source trajectory (fixed at the start pose) and the
destination one (moving to the end pose over `move_time` frames) on the host
(geometry.render_point_cloud), and returns NHWC numpy arrays; collate
(data/loader.py) merges (B, T) into B*T. The same streams, trajectories,
retries and dict as the JAX package's dataset.

For evaluation, `set_next_example` fixes an item's scene, frames and camera
move, and `reproject_rgbd = True` adds "reproject": the RGBD-reprojection
baseline, stored view 4's points alone (view 0 in a root of 4 views or
fewer) rendered along the destination trajectory with a 3-pixel hole fill,
whose black pixels are what that one view cannot see.

On-disk layout (the reference converter's): {dset_root}/scnNNNNN/
scnNNNNN_p0_v4.json (Kubric metadata) and {pcl_root}/scnNNNNN/
pcl_rgb_segm_TTTTT.pt (a torch list [xyz f16, rgb u8, segm u8], each
(views, points, 3)).
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from gcd_tpu_torch.data import common, geometry
from gcd_tpu_torch.data.loader import PrefetchLoader

# The reprojection baseline: the stored view whose points it renders (the
# first "dense low down" viewpoint of the converter's 16) and its hole fill.
REPROJECT_VIEW = 4
REPROJECT_BLUR = 3


def load_point_cloud_file(fp: str):
    """A converter's `pcl_rgb_segm_XXXXX.pt` as numpy (xyz, rgb, segm)."""
    pcl_xyz, pcl_rgb, pcl_segm = torch.load(fp, map_location="cpu", weights_only=True)
    return pcl_xyz.numpy(), pcl_rgb.numpy(), pcl_segm.numpy()


class KubricSynthViewDataset:
    def __init__(
        self, dset_root, start_idx, end_idx, force_shuffle=False,
        pcl_root="",
        avail_frames=60, model_frames=14,
        input_frames=7, output_frames=14,
        center_crop=True, frame_width=384, frame_height=256,
        input_mode="arbitrary", output_mode="arbitrary",
        input_modality="rgb", output_modality="rgb",
        azimuth_range=(0.0, 360.0),
        elevation_range=(0.0, 50.0),
        radius_range=(12.0, 18.0),
        delta_azimuth_range=(-60.0, 60.0),
        delta_elevation_range=(-30.0, 30.0),
        delta_radius_range=(-3.0, 3.0),
        elevation_sample_sin=False,
        trajectory="interpol_linear", move_time=10,
        camera_control="spherical", motion_bucket_range=(127, 127),
        cond_aug=0.02, mock_dset_size=1000,
        reverse_prob=0.2, data_gpu=0,
        spread_radius=1, render_width=420, render_height=280,
        seed=0,
        **kwargs,
    ):
        self.dset_root = dset_root
        self.pcl_root = pcl_root
        self.start_idx = int(start_idx)
        self.end_idx = int(end_idx)
        self.num_scenes = self.end_idx - self.start_idx
        self.force_shuffle = force_shuffle
        self.avail_frames = min(int(avail_frames), 60)
        self.model_frames = int(model_frames)
        self.input_frames = int(input_frames)
        self.output_frames = int(output_frames)
        self.center_crop = center_crop
        self.frame_width = int(frame_width)
        self.frame_height = int(frame_height)
        self.input_mode = input_mode
        self.output_mode = output_mode
        self.azimuth_range = list(azimuth_range)
        self.elevation_range = list(elevation_range)
        self.radius_range = list(radius_range)
        self.delta_azimuth_range = list(delta_azimuth_range)
        self.delta_elevation_range = list(delta_elevation_range)
        self.delta_radius_range = list(delta_radius_range)
        self.elevation_sample_sin = elevation_sample_sin
        self.trajectory = trajectory
        self.move_time = int(move_time)
        self.camera_control = camera_control
        self.motion_bucket_range = list(motion_bucket_range)
        self.cond_aug = float(cond_aug)
        self.mock_dset_size = int(mock_dset_size)
        self.reverse_prob = float(reverse_prob)
        self.spread_radius = int(spread_radius)
        self.render_width = int(render_width)
        self.render_height = int(render_height)
        self.seed = int(seed)

        self.avail_views = 16
        self.avail_fps = 24
        self.next_example = None
        self.max_retries = 100
        self.reproject_rgbd = False

    def set_next_example(self, *args):
        """Deterministic override: [scene_idx, frame_skip, frame_start,
        reverse, azimuth_start, azimuth_end, elevation_start, elevation_end,
        radius_start, radius_end]."""
        self.next_example = list(args)

    def __len__(self):
        return self.mock_dset_size

    # -- sampling ----------------------------------------------------------

    def _sample_start(self, rng):
        az0, az1 = self.azimuth_range
        azimuth = az0 if az1 - az0 <= 0 else rng.uniform(az0, az1)
        el0, el1 = self.elevation_range
        if el1 - el0 <= 0:
            elevation = el0
        elif self.elevation_sample_sin:
            bounds = np.sin(np.deg2rad([el0, el1]))
            elevation = np.rad2deg(np.arcsin(rng.uniform(*bounds)))
        else:
            elevation = rng.uniform(el0, el1)
        r0, r1 = self.radius_range
        radius = r0 if r1 - r0 <= 0 else rng.uniform(r0, r1)
        return azimuth, elevation, radius

    def _sample_end(self, rng, azimuth_start, elevation_start, radius_start):
        da = self.delta_azimuth_range
        if da[1] - da[0] <= 0:
            azimuth_end = azimuth_start + da[0]
        elif self.azimuth_range[1] - self.azimuth_range[0] >= 360.0:
            azimuth_end = azimuth_start + rng.uniform(*da)
        else:
            azimuth_end = rng.uniform(max(azimuth_start + da[0], self.azimuth_range[0]),
                                      min(azimuth_start + da[1], self.azimuth_range[1]))
        de = self.delta_elevation_range
        if len(de) != 2:
            elevation_end = de[0]  # absolute
        elif de[1] - de[0] <= 0:
            elevation_end = elevation_start + de[0]
        else:
            elevation_end = rng.uniform(max(elevation_start + de[0], self.elevation_range[0]),
                                        min(elevation_start + de[1], self.elevation_range[1]))
        dr = self.delta_radius_range
        if len(dr) != 2:
            radius_end = dr[0]  # absolute
        elif dr[1] - dr[0] <= 0:
            radius_end = radius_start + dr[0]
        else:
            radius_end = rng.uniform(max(radius_start + dr[0], self.radius_range[0]),
                                     min(radius_start + dr[1], self.radius_range[1]))
        return azimuth_end, elevation_end, radius_end

    def sample_trajectories(self, rng, spherical_start=None, spherical_end=None):
        """Spherical and extrinsics trajectories of both cameras, and the
        move's size normalised by the largest allowed one. The start and end
        poses (azimuth, elevation, radius) are the `set_next_example`
        override's, else `spherical_start` / `spherical_end` where given,
        else drawn from rng."""
        tcm = self.model_frames
        assert self.input_mode == "arbitrary" and self.output_mode == "arbitrary"

        if self.next_example is not None and len(self.next_example) > 4 and \
                self.next_example[4] > -1000:
            (azimuth_start, azimuth_end, elevation_start, elevation_end,
             radius_start, radius_end) = [float(v) for v in self.next_example[4:10]]
        else:
            if spherical_start is None:
                azimuth_start, elevation_start, radius_start = self._sample_start(rng)
            else:
                azimuth_start, elevation_start, radius_start = spherical_start
            if spherical_end is None:
                azimuth_end, elevation_end, radius_end = self._sample_end(
                    rng, azimuth_start, elevation_start, radius_start)
            else:
                azimuth_end, elevation_end, radius_end = spherical_end

        spherical_start = np.array([azimuth_start, elevation_start, radius_start],
                                   dtype=np.float32)
        spherical_end = np.array([azimuth_end, elevation_end, radius_end], dtype=np.float32)

        my_motion = np.linalg.norm(spherical_end[0:2] - spherical_start[0:2])
        max_motion = np.linalg.norm([max(*self.delta_azimuth_range),
                                     max(*self.delta_elevation_range)])
        motion_amount = float(my_motion / max_motion) if max_motion > 0 else 0.0

        spherical_src, spherical_dst = common.construct_trajectory(
            spherical_start, spherical_end, self.trajectory, tcm, self.move_time)

        position_src = geometry.cartesian_from_spherical(spherical_src, deg2rad=True)
        position_src[..., 2] += 1.0
        position_dst = geometry.cartesian_from_spherical(spherical_dst, deg2rad=True)
        position_dst[..., 2] += 1.0
        look_at = np.array([0.0, 0.0, 1.0])
        extrinsics_src = np.stack([geometry.extrinsics_from_look_at(position_src[t], look_at)
                                   for t in range(tcm)]).astype(np.float32)
        extrinsics_dst = np.stack([geometry.extrinsics_from_look_at(position_dst[t], look_at)
                                   for t in range(tcm)]).astype(np.float32)
        return (spherical_src.astype(np.float32), spherical_dst.astype(np.float32),
                extrinsics_src, extrinsics_dst, motion_amount)

    # -- rendering ---------------------------------------------------------

    def _used_intrinsics(self, norm_intrinsics: np.ndarray) -> np.ndarray:
        """Normalised K at the render resolution, with the reference's
        aspect-ratio fix."""
        k = norm_intrinsics.copy()
        k[0, :] *= self.render_width
        k[1, :] *= self.render_height
        old_ar = 576.0 / 384.0
        new_ar = self.render_width / self.render_height
        if new_ar > old_ar + 1e-3:
            k[1, 1] = k[0, 0]
        elif new_ar < old_ar - 1e-3:
            k[0, 0] = k[1, 1]
        return k

    def _render_traj_frame(self, xyz, rgb, intrinsics, extrinsics, blur_radius=21):
        img = geometry.render_point_cloud(
            xyz, rgb, intrinsics, extrinsics, self.render_height, self.render_width,
            spread_radius=self.spread_radius, mode="kubric", blur_kernel=blur_radius)
        return common.process_image(img, center_crop=False, frame_width=self.frame_width,
                                    frame_height=self.frame_height)

    def synth_src_dst_rgb(self, pcl_frames, extrinsics_src, extrinsics_dst, avail_intrinsics):
        """Both trajectories rendered from the merged clouds, and with
        `reproject_rgbd` the reprojection baseline (else None); pcl_frames
        is a list of (xyz (V, N, 3) f16, rgb (V, N, 3) u8, ...) per frame."""
        used_k = self._used_intrinsics(avail_intrinsics[0])
        rgb_src, rgb_dst = [], []
        reproject = [] if self.reproject_rgbd else None
        for t in range(self.model_frames):
            xyz, rgb = pcl_frames[t][0], pcl_frames[t][1]
            xyz_flat = xyz.reshape(-1, 3).astype(np.float32)
            rgb_flat = rgb.reshape(-1, 3).astype(np.float32) / 255.0
            rgb_src.append(self._render_traj_frame(xyz_flat, rgb_flat, used_k,
                                                   extrinsics_src[t]))
            rgb_dst.append(self._render_traj_frame(xyz_flat, rgb_flat, used_k,
                                                   extrinsics_dst[t]))
            if reproject is not None:
                v = REPROJECT_VIEW if xyz.shape[0] > REPROJECT_VIEW else 0
                reproject.append(self._render_traj_frame(
                    xyz[v].astype(np.float32), rgb[v].astype(np.float32) / 255.0, used_k,
                    extrinsics_dst[t], blur_radius=REPROJECT_BLUR))
        return (np.stack(rgb_src), np.stack(rgb_dst),
                np.stack(reproject) if reproject is not None else None)

    # -- batch dict --------------------------------------------------------

    def construct_dict(self, rng, rgb_src, rgb_dst, reproject, fps, spherical_src,
                       spherical_dst, extrinsics_src, extrinsics_dst, motion_amount) -> Dict:
        """The item's arrays, each (model_frames, ...) but the indicator;
        "reproject" where a baseline is given."""
        tcm = self.model_frames
        tci, tco = self.input_frames, self.output_frames

        cond_aug = np.full((tcm,), self.cond_aug, dtype=np.float32)
        m0, m1 = self.motion_bucket_range
        motion_value = int(m0) if m1 - m0 <= 0 else int(round(m0 + (m1 - m0) * motion_amount))
        motion_bucket_id = np.full((tcm,), motion_value, dtype=np.int32)
        fps_id = np.full((tcm,), fps, dtype=np.int32)
        image_only_indicator = np.zeros((1, tcm), dtype=np.float32)

        scaled_rel_pose = np.zeros((tcm, 3, 4), dtype=np.float32)
        for t in range(tcm):
            delta = np.linalg.inv(extrinsics_src[t]) @ extrinsics_dst[t]
            scaled_rel_pose[t] = delta[0:3, 0:4]

        scaled_rel_angles = (spherical_dst - spherical_src).astype(np.float32)
        scaled_rel_angles[:, 0] *= np.pi / 180.0
        scaled_rel_angles[:, 1] *= np.pi / 180.0

        data = {
            "cond_aug": cond_aug,
            "motion_bucket_id": motion_bucket_id,
            "fps_id": fps_id,
            "image_only_indicator": image_only_indicator,
            "scaled_relative_pose": scaled_rel_pose,
            "scaled_relative_angles": scaled_rel_angles,
        }
        target_frames = rgb_dst
        if tco < tcm:
            target_frames = np.concatenate(
                [target_frames[0:tco]] + [target_frames[tco - 1:tco]] * (tcm - tco), axis=0)
        cond_no_noise = rgb_src
        if tci < tcm:
            cond_no_noise = np.concatenate(
                [cond_no_noise[0:tci]] + [cond_no_noise[tci - 1:tci]] * (tcm - tci), axis=0)
        assert target_frames.shape[1:3] == (self.frame_height, self.frame_width)
        cond_frames = (cond_no_noise
                       + self.cond_aug * rng.standard_normal(cond_no_noise.shape)
                       ).astype(np.float32)
        data["jpg"] = target_frames.astype(np.float32)
        data["cond_frames"] = cond_frames
        data["cond_frames_without_noise"] = cond_no_noise.astype(np.float32)
        if reproject is not None:
            data["reproject"] = reproject.astype(np.float32)
        return data

    # -- main --------------------------------------------------------------

    def __getitem__(self, idx: int) -> Dict:
        tv, tcm = self.avail_frames, self.model_frames
        for retry_idx in range(self.max_retries):
            rng = np.random.default_rng((self.seed, int(idx), retry_idx))
            try:
                if self.next_example is not None:
                    scene_idx = int(self.next_example[0])
                    frame_skip = int(self.next_example[1])
                    frame_start = int(self.next_example[2])
                    reverse = bool(self.next_example[3])
                else:
                    if retry_idx >= 1 or self.force_shuffle:
                        idx2 = rng.integers(0, self.mock_dset_size)
                        idx = int((idx2 + idx) % self.mock_dset_size)
                    scene_idx = idx % self.num_scenes + self.start_idx
                    max_skip = tv // tcm
                    frame_skip = int(rng.integers(1, max_skip + 1))
                    desired_max_offset = 6
                    cover_video = frame_skip * (tcm - 1) + 1
                    max_frame_start = tv - cover_video - 1
                    used_max = max(min(max_frame_start, desired_max_offset), 0)
                    frame_start = int(rng.integers(0, used_max + 1))
                    reverse = bool(rng.random() < self.reverse_prob)

                scene_dn = f"scn{scene_idx:05d}"
                scene_dp = os.path.join(self.dset_root, scene_dn)
                pcl_dp = os.path.join(self.pcl_root, scene_dn)

                fps = int(round(self.avail_fps / frame_skip))
                clip_frames = np.arange(tcm) * frame_skip + frame_start
                if not (0 <= clip_frames[0] and clip_frames[-1] <= tv - 1):
                    raise ValueError(f"clip frames {clip_frames} outside 0..{tv - 1}")
                if reverse:
                    clip_frames = clip_frames[::-1].copy()

                metadata = common.load_json(os.path.join(scene_dp, f"{scene_dn}_p0_v4.json"))
                first_intrinsics, _ = geometry.get_kubric_camera_matrices(metadata)
                pcl_frames = [load_point_cloud_file(os.path.join(pcl_dp,
                                                                 f"pcl_rgb_segm_{t:05d}.pt"))
                              for t in clip_frames]
                (spherical_src, spherical_dst, extrinsics_src, extrinsics_dst,
                 motion_amount) = self.sample_trajectories(rng)
                rgb_src, rgb_dst, reproject = self.synth_src_dst_rgb(
                    pcl_frames, extrinsics_src, extrinsics_dst, first_intrinsics)
                data = self.construct_dict(rng, rgb_src, rgb_dst, reproject, fps, spherical_src,
                                           spherical_dst, extrinsics_src, extrinsics_dst,
                                           motion_amount)
                break
            except Exception as e:
                common.log_retry("KubricSynthViewDataset", idx, retry_idx, self.max_retries, e)
                if retry_idx >= self.max_retries - 2:
                    raise
                time.sleep(min(0.2 + retry_idx * 0.02, 1.0))

        data["dset"] = np.array([1])
        data["idx"] = np.array([idx])
        data["scene_idx"] = np.array([scene_idx])
        data["frame_start"] = np.array([frame_start])
        data["frame_skip"] = np.array([frame_skip])
        data["clip_frames"] = np.asarray(clip_frames)
        return data


class KubricSynthViewModule:
    """The training split (scenes [0, train_videos)), the validation split
    (scenes [train_videos, train_videos + val_videos)) and their loaders.
    The evaluation entry (gcd_tpu_torch/test.py) renders its examples
    through the validation split."""

    def __init__(self, dset_root, train_videos, val_videos, test_videos, batch_size,
                 num_workers, shuffle=True, **kwargs):
        self.batch_size = int(batch_size)
        self.num_workers = int(num_workers)
        self.shuffle = shuffle
        self.train_dataset = KubricSynthViewDataset(dset_root, 0, train_videos, **kwargs)
        self.val_dataset = KubricSynthViewDataset(dset_root, train_videos,
                                                  train_videos + val_videos, **kwargs)

    def train_dataloader(self):
        return PrefetchLoader(self.train_dataset, self.batch_size, shuffle=self.shuffle,
                              num_workers=self.num_workers)

    def val_dataloader(self):
        return PrefetchLoader(self.val_dataset, self.batch_size, shuffle=self.shuffle,
                              num_workers=self.num_workers)

"""ParallelDomain-4D training pairs: driving scenes seen from the ego car and
synthesised from above (port of gcd_tpu/data/pardom.py:24-525).

An item picks a scene, a clip of `model_frames` of its 50 frames, and the
two cameras' trajectories from np.random.default_rng((seed, idx, retry)).
The source clip is read from the scene's frames (`ego_forward`: the front
ego camera; `magic_random`: one of the 16 surround cameras) or rendered
from the clip's merged point clouds (`traffic1`); the destination clip is
rendered from the clouds along a top-down (`topdown1`, `topdown2`) or
random look-down (`traffic1`) camera that moves there over `move_time`
frames, or read from the opposite surround camera (`magic_opposite`). A
`segm` modality renders or reads the ontology's class colours instead of
RGB; `modal_time` > 0 blends from RGB to them over the first frames.
Rendering is the host splat in its ParallelDomain mode (sqrt depth,
gcd_tpu_torch.native); frames are read by the port's PNG reader. The same
streams, trajectories, retries and dict as the JAX package's dataset.

On-disk layout (the reference converter's): {dset_root}/scene_NNNNNN/
calibration/*.json, ontology/*.json, {modality}/{camera}/{t*10+5:018d}.png,
and {pcl_root}/scene_NNNNNN/pcl_rgb_segm_{t*10+5:06d}.pt (a torch list
[xyz f16, rgb u8, segm-id u8, view-tag u8], each (19 views, points, C)).
"""

from __future__ import annotations

import glob
import os
import time
from typing import Dict

import numpy as np
import torch

from gcd_tpu_torch.data import common, geometry
from gcd_tpu_torch.data.loader import PrefetchLoader

INPUT_MODES = ("ego_forward", "magic_random", "traffic1")
OUTPUT_MODES = ("topdown1", "topdown2", "magic_opposite", "traffic1")


def load_pd_point_cloud_file(fp: str):
    """A converter's `pcl_rgb_segm_XXXXXX.pt` as numpy (xyz f16, rgb u8,
    segm u8, view tag u8), each (views, points, C)."""
    xyz, rgb, segm, tag = torch.load(fp, map_location="cpu", weights_only=True)
    return xyz.numpy(), rgb.numpy(), segm.numpy(), tag.numpy()


class ParallelDomainSynthViewDataset:
    def __init__(
        self, dset_root, split, start_idx, end_idx, force_shuffle=False,
        pcl_root="", split_json="",
        avail_frames=50, model_frames=14,
        input_frames=7, output_frames=14,
        center_crop=True, frame_width=384, frame_height=256,
        input_mode="ego_forward", output_mode="topdown1",
        input_modality="rgb", output_modality="rgb",
        dst_cam_position=(-8.0, 0.0, 8.0),
        dst_cam_look_at=(5.60, 0.0, 1.55),
        dst_azimuth_range=(0.0, 0.0),
        dst_forward_offset=8.0,
        dst_pos_side_offset=9.0,
        dst_look_side_offset=-1.20,
        trajectory="interpol_sine", move_time=10, modal_time=0,
        camera_control="none", motion_bucket_range=(127, 127),
        cond_aug=0.02, mock_dset_size=1000,
        reverse_prob=0.05, data_gpu=0,
        spread_radius=1, render_width=420, render_height=280,
        seed=0,
        **kwargs,
    ):
        self.dset_root = dset_root
        self.pcl_root = pcl_root
        self.split = split
        self.split_json = split_json
        self.avail_frames = 50  # every PD scene has 50; the argument is ignored
        self.model_frames = int(model_frames)
        self.input_frames = int(input_frames)
        self.output_frames = int(output_frames)
        self.center_crop = center_crop
        self.frame_width = int(frame_width)
        self.frame_height = int(frame_height)
        self.input_mode = input_mode
        self.output_mode = output_mode
        self.input_modality = input_modality
        self.output_modality = output_modality
        self.dst_cam_position = list(dst_cam_position)
        self.dst_cam_look_at = list(dst_cam_look_at)
        self.dst_azimuth_range = list(dst_azimuth_range)
        self.dst_forward_offset = float(dst_forward_offset)
        self.dst_pos_side_offset = float(dst_pos_side_offset)
        self.dst_look_side_offset = float(dst_look_side_offset)
        self.trajectory = trajectory
        self.move_time = int(move_time)
        self.modal_time = int(modal_time)
        self.camera_control = camera_control
        self.motion_bucket_range = list(motion_bucket_range)
        self.cond_aug = float(cond_aug)
        self.mock_dset_size = int(mock_dset_size)
        self.reverse_prob = float(reverse_prob)
        self.force_shuffle = force_shuffle
        self.spread_radius = int(spread_radius)
        self.render_width = int(render_width)
        self.render_height = int(render_height)
        self.seed = int(seed)
        self._check_modes()

        if len(self.split_json) == 0:
            all_scene_dps = [os.path.join(self.dset_root, dn)
                             for dn in sorted(os.listdir(self.dset_root))]
            all_scene_dps = [dp for dp in all_scene_dps if os.path.isdir(dp) and "scene" in dp]
            all_scene_dns = [os.path.basename(dp) for dp in all_scene_dps[start_idx:end_idx]]
            self.num_scenes = end_idx - start_idx
            self.start_idx, self.end_idx = start_idx, end_idx
        else:
            # A relative path is read from the working directory, as the
            # reference's is.
            all_scene_dns = common.load_json(self.split_json)[split]
            self.num_scenes = len(all_scene_dns)
            self.start_idx, self.end_idx = 0, self.num_scenes
        self.all_scene_dns = all_scene_dns

        self.avail_ego_views = 3
        self.avail_magic_views = 16
        self.avail_fps = 10

        # The ontology's id -> colour map (in [0, 1]), from the first scene.
        ontology_fps = glob.glob(os.path.join(self.dset_root, "scene_000000", "ontology",
                                              "*.json"))
        self.ontology = (common.load_json(ontology_fps[0]) if ontology_fps
                         else {"items": []})
        id_rgb = {x["id"]: (x["color"]["r"], x["color"]["g"], x["color"]["b"])
                  for x in self.ontology.get("items", [])}
        semantic_map = np.zeros((max(id_rgb.keys(), default=0) + 1, 3), dtype=np.float32)
        for k, v in id_rgb.items():
            semantic_map[k] = np.asarray(v, dtype=np.float32) / 255.0
        self.ontology["semantic_id_rgb_map"] = semantic_map

        self.next_example = None
        self.max_retries = 100
        self.reproject_rgbd = False

    def _check_modes(self) -> None:
        """The camera modes and the pairs of them that sample_trajectories
        takes (an item would otherwise fail on every retry)."""
        if self.input_mode not in INPUT_MODES or self.output_mode not in OUTPUT_MODES:
            raise ValueError(f"input_mode {self.input_mode!r} / output_mode "
                             f"{self.output_mode!r}: expected one of {INPUT_MODES} / "
                             f"{OUTPUT_MODES}")
        if self.output_mode == "topdown1" and self.dst_azimuth_range != [0.0, 0.0]:
            raise ValueError("output_mode topdown1 takes dst_azimuth_range [0, 0]")
        if self.output_mode == "magic_opposite" and (self.input_mode != "magic_random"
                                                     or self.move_time != 0):
            raise ValueError("output_mode magic_opposite takes input_mode magic_random and "
                             "move_time 0")
        if self.output_mode == "traffic1" and self.input_mode != "traffic1":
            raise ValueError("output_mode traffic1 takes input_mode traffic1")

    def set_next_example(self, *args):
        """Deterministic override: [scene_idx, scene_dn, frame_skip,
        frame_start, reverse]; a negative scene_idx makes a camera-only item
        (no frames) of scene_000000's calibration."""
        self.next_example = list(args)

    def __len__(self):
        return self.mock_dset_size

    # -- camera sampling ---------------------------------------------------

    def sample_traffic1(self, rng, azimuth_src_deg=None):
        """A camera looking down at the ego car from a random azimuth (or the
        source's plus dst_azimuth_range), height and radius: (positions,
        look-ats, azimuth, height, radius)."""
        if azimuth_src_deg is None:
            azimuth_deg = rng.uniform(0.0, 360.0)
        else:
            azimuth_deg = azimuth_src_deg + rng.uniform(*self.dst_azimuth_range)
        azimuth_rad = np.deg2rad(azimuth_deg)
        height = rng.uniform(4.0, 12.0)
        radius = rng.uniform(8.0, 22.0)
        position = np.array([radius * np.cos(azimuth_rad), radius * np.sin(azimuth_rad),
                             height], dtype=np.float32)
        position = np.tile(position[None], (self.model_frames, 1))
        look_at = np.tile(np.zeros(3, dtype=np.float32)[None], (self.model_frames, 1))
        return position, look_at, azimuth_deg, height, radius

    def sample_trajectories(self, rng, avail_extrinsics, avail_intrinsics):
        """Both cameras' extrinsics and normalised intrinsics per frame, the
        readable angles, the magic view indices (-1 where unused) and the
        motion amount."""
        tcm = self.model_frames
        src_view_idx = -1
        azimuth_src_deg = height_src = radius_src = None
        if self.input_mode == "ego_forward":
            position_src = np.tile(np.array([1.60, 0.0, 1.55], dtype=np.float32)[None],
                                   (tcm, 1))
            look_at_src = np.tile(np.array([6.60, 0.0, 1.55], dtype=np.float32)[None],
                                  (tcm, 1))
        elif self.input_mode == "magic_random":
            src_view_idx = int(rng.integers(0, self.avail_magic_views))
            pos = avail_extrinsics[src_view_idx, 0:3, 3]
            position_src = np.tile(pos[None].astype(np.float32), (tcm, 1))
            look_at_src = np.tile(np.array([0.0, 0.0, -2.0], dtype=np.float32)[None],
                                  (tcm, 1))
        else:  # traffic1
            (position_src, look_at_src, azimuth_src_deg, height_src,
             radius_src) = self.sample_traffic1(rng)

        dst_view_idx = -1
        readable_angles = np.zeros((tcm, 3), dtype=np.float32)
        if self.output_mode == "topdown1":
            position_dst = np.tile(np.asarray(self.dst_cam_position, dtype=np.float32)[None],
                                   (tcm, 1))
            look_at_dst = np.tile(np.asarray(self.dst_cam_look_at, dtype=np.float32)[None],
                                  (tcm, 1))
        elif self.output_mode == "topdown2":
            azimuth_deg = rng.uniform(*self.dst_azimuth_range)
            azimuth_rad = np.deg2rad(azimuth_deg)
            unit = np.array([1.0 - np.cos(azimuth_rad), np.sin(azimuth_rad), 0.0],
                            dtype=np.float32)
            position_dst = np.array([
                unit[0] * (self.dst_forward_offset - self.dst_cam_position[0])
                + self.dst_cam_position[0],
                unit[1] * (self.dst_pos_side_offset - self.dst_cam_position[1])
                + self.dst_cam_position[1],
                self.dst_cam_position[2],
            ], dtype=np.float32)
            look_at_dst = np.array([
                unit[0] * (self.dst_forward_offset - self.dst_cam_look_at[0])
                + self.dst_cam_look_at[0],
                unit[1] * (self.dst_look_side_offset - self.dst_cam_look_at[1])
                + self.dst_cam_look_at[1],
                self.dst_cam_look_at[2],
            ], dtype=np.float32)
            position_dst = np.tile(position_dst[None], (tcm, 1))
            look_at_dst = np.tile(look_at_dst[None], (tcm, 1))
            readable_angles = np.tile(
                np.array([np.deg2rad(azimuth_deg), 0.0, 0.0], dtype=np.float32)[None],
                (tcm, 1))
        elif self.output_mode == "magic_opposite":
            dst_view_idx = (src_view_idx + self.avail_magic_views // 2) % self.avail_magic_views
            pos = avail_extrinsics[dst_view_idx, 0:3, 3]
            position_dst = np.tile(pos[None].astype(np.float32), (tcm, 1))
            look_at_dst = np.tile(np.array([0.0, 0.0, -2.0], dtype=np.float32)[None],
                                  (tcm, 1))
            readable_angles = np.tile(np.array([np.pi, 0.0, 0.0], dtype=np.float32)[None],
                                      (tcm, 1))
        else:  # traffic1
            (position_dst, look_at_dst, azimuth_dst_deg, height_dst,
             radius_dst) = self.sample_traffic1(rng, azimuth_src_deg=azimuth_src_deg)
            readable_angles = np.tile(np.array([
                np.deg2rad(azimuth_dst_deg - azimuth_src_deg),
                height_dst - height_src,
                radius_dst - radius_src,
            ], dtype=np.float32)[None], (tcm, 1))

        motion_amount = 0.5

        # The ego camera's intrinsics for both trajectories.
        intrinsics_src = np.tile(avail_intrinsics[-2:-1], (tcm, 1, 1)).copy()
        intrinsics_dst = np.tile(avail_intrinsics[-2:-1], (tcm, 1, 1)).copy()

        for t in range(min(self.move_time, tcm)):
            if self.trajectory == "interpol_linear":
                alpha = t / self.move_time
            elif self.trajectory == "interpol_sine":
                alpha = (1.0 - np.cos(t / self.move_time * np.pi)) / 2.0
            else:
                raise ValueError(self.trajectory)
            p_start, p_end = position_src[t].copy(), position_dst[t].copy()
            if self.input_mode == "traffic1" and self.output_mode == "traffic1":
                position_dst[t] = geometry.interpolate_spherical(p_start, p_end, alpha)
            else:
                position_dst[t] = p_start * (1 - alpha) + p_end * alpha
            look_at_dst[t] = look_at_src[t] * (1 - alpha) + look_at_dst[t] * alpha
            intrinsics_dst[t] = intrinsics_src[t] * (1 - alpha) + intrinsics_dst[t] * alpha

        extrinsics_src = np.stack([geometry.extrinsics_from_look_at(position_src[t],
                                                                    look_at_src[t])
                                   for t in range(tcm)]).astype(np.float32)
        extrinsics_dst = np.stack([geometry.extrinsics_from_look_at(position_dst[t],
                                                                    look_at_dst[t])
                                   for t in range(tcm)]).astype(np.float32)

        # Intrinsics normalised by the 640 x 480 frames.
        for k in (intrinsics_src, intrinsics_dst):
            k[:, 0, :] /= 640.0
            k[:, 1, :] /= 480.0

        return (extrinsics_src, extrinsics_dst, intrinsics_src, intrinsics_dst,
                readable_angles, src_view_idx, dst_view_idx, motion_amount)

    # -- rendering ---------------------------------------------------------

    def _used_intrinsics(self, norm_k: np.ndarray) -> np.ndarray:
        """Normalised K at the render resolution, with the reference's
        aspect-ratio fix."""
        k = norm_k.copy()
        k[0, :] *= self.render_width
        k[1, :] *= self.render_height
        old_ar = 640.0 / 480.0
        new_ar = self.render_width / self.render_height
        if new_ar > old_ar + 1e-3:
            k[1, 1] = k[0, 0]
        elif new_ar < old_ar - 1e-3:
            k[0, 0] = k[1, 1]
        return k

    def _point_colors(self, t, rgb, segm):
        """The points' colours at frame t: RGB, or the ontology's class
        colours, blended from RGB over the first `modal_time` frames."""
        cur_rgb = rgb.astype(np.float32) / 255.0
        modality = self.output_modality
        if modality == "rgb":
            return cur_rgb
        if modality != "segm":
            raise ValueError(f"output_modality {modality!r}: expected rgb or segm")
        semantic_map = self.ontology["semantic_id_rgb_map"]
        ids = np.clip(segm[..., 0].astype(np.int64), 0, len(semantic_map) - 1)
        segm_rgb = semantic_map[ids]
        if 0 < t < self.modal_time:
            alpha = t / self.modal_time
            return (1.0 - alpha) * cur_rgb + alpha * segm_rgb
        if t == 0 and self.modal_time > 0:
            return cur_rgb
        return segm_rgb.astype(np.float32)

    def synth_rgb(self, pcl_frames, modality, extrinsics, intrinsics, calc_reproject=False):
        """Render each frame's merged cloud from the given cameras: (T, H, W,
        3) in [-1, 1], and with `calc_reproject` and `reproject_rgbd` the
        RGBD-reprojection baseline from the forward ego view's points alone
        (stored view 16, blur 3), else None."""
        out = []
        reproject = [] if (calc_reproject and self.reproject_rgbd) else None
        for t in range(self.model_frames):
            xyz, rgb, segm, _ = pcl_frames[t]
            used_k = self._used_intrinsics(intrinsics[t])
            if modality == "segm":
                colors = self._point_colors(t, rgb, segm)
            else:
                colors = rgb.astype(np.float32) / 255.0
            xyz_flat = xyz.reshape(-1, 3).astype(np.float32)
            col_flat = colors.reshape(-1, 3)
            # f16 PD clouds hold inf / huge coordinates: put them at the origin.
            finite = np.isfinite(xyz_flat).all(axis=-1)
            xyz_flat = np.where(finite[:, None], xyz_flat, 0.0)
            img = geometry.render_point_cloud(
                xyz_flat, col_flat, used_k, extrinsics[t], self.render_height,
                self.render_width, spread_radius=self.spread_radius, mode="pardom",
                blur_kernel=21)
            out.append(common.process_image(img, False, self.frame_width, self.frame_height))
            if reproject is not None:
                img2 = geometry.render_point_cloud(
                    xyz[16].astype(np.float32), colors[16], used_k, extrinsics[t],
                    self.render_height, self.render_width, spread_radius=self.spread_radius,
                    mode="pardom", blur_kernel=3)
                reproject.append(common.process_image(img2, False, self.frame_width,
                                                      self.frame_height))
        return np.stack(out), (np.stack(reproject) if reproject is not None else None)

    # -- batch dict --------------------------------------------------------

    def construct_dict(self, rng, rgb_src, rgb_dst, reproject, fps, readable_angles,
                       src_view_idx, dst_view_idx, extrinsics_src, extrinsics_dst,
                       motion_amount) -> Dict:
        """The item's arrays, each (model_frames, ...) but the indicator and
        the view indices; no frames when rgb_src / rgb_dst are None."""
        tcm, tci, tco = self.model_frames, self.input_frames, self.output_frames
        m0, m1 = self.motion_bucket_range
        motion_value = int(m0) if m1 - m0 <= 0 else int(round(m0 + (m1 - m0) * motion_amount))
        data = {
            "cond_aug": np.full((tcm,), self.cond_aug, dtype=np.float32),
            "motion_bucket_id": np.full((tcm,), motion_value, dtype=np.int32),
            "fps_id": np.full((tcm,), fps, dtype=np.int32),
            "image_only_indicator": np.zeros((1, tcm), dtype=np.float32),
            "scaled_relative_angles": readable_angles.astype(np.float32),
        }
        pose = np.zeros((tcm, 3, 4), dtype=np.float32)
        for t in range(tcm):
            pose[t] = (np.linalg.inv(extrinsics_src[t]) @ extrinsics_dst[t])[0:3, 0:4]
        data["scaled_relative_pose"] = pose

        if rgb_src is not None and rgb_dst is not None:
            target = rgb_dst
            if tco < tcm:
                target = np.concatenate([target[0:tco]] + [target[tco - 1:tco]] * (tcm - tco))
            cond_nn = rgb_src
            if tci < tcm:
                cond_nn = np.concatenate([cond_nn[0:tci]] + [cond_nn[tci - 1:tci]] * (tcm - tci))
            cond = (cond_nn + self.cond_aug * rng.standard_normal(cond_nn.shape)
                    ).astype(np.float32)
            data["jpg"] = target.astype(np.float32)
            data["cond_frames"] = cond
            data["cond_frames_without_noise"] = cond_nn.astype(np.float32)
            data["src_view_idx"] = np.array([src_view_idx], dtype=np.int32)
            data["dst_view_idx"] = np.array([dst_view_idx], dtype=np.int32)
        if reproject is not None:
            data["reproject"] = reproject.astype(np.float32)
        return data

    # -- main --------------------------------------------------------------

    def _load_clip(self, rng, scene_idx, scene_dn, clip_frames):
        """The clip's camera trajectories, its source and destination frames
        and the reprojection baseline (None with a negative scene_idx)."""
        scene_dp = os.path.join(self.dset_root, scene_dn)
        pcl_dp = os.path.join(self.pcl_root, scene_dn)
        calibration = common.load_json(
            glob.glob(os.path.join(scene_dp, "calibration", "*.json"))[0])
        _, all_intrinsics, all_extrinsics = geometry.get_pardom_camera_matrices(calibration)
        pcl_frames = None
        if scene_idx >= 0:
            pcl_frames = [load_pd_point_cloud_file(
                os.path.join(pcl_dp, f"pcl_rgb_segm_{t * 10 + 5:06d}.pt")) for t in clip_frames]
        traj = self.sample_trajectories(rng, all_extrinsics, all_intrinsics)
        (extrinsics_src, extrinsics_dst, intrinsics_src, intrinsics_dst,
         _, src_view_idx, dst_view_idx, _) = traj
        if scene_idx < 0:
            return traj, None, None, None

        def vis_frames(modality, kind, view):
            return common.load_pardom_video_vis_frames(
                scene_dp, modality, kind, view, self.ontology, clip_frames, self.center_crop,
                self.frame_width, self.frame_height)

        if self.input_mode == "ego_forward":
            rgb_src = vis_frames(self.input_modality, "ego", 1)
        elif self.input_mode == "magic_random":
            rgb_src = vis_frames(self.input_modality, "magic", src_view_idx)
        else:
            rgb_src, _ = self.synth_rgb(pcl_frames, self.input_modality, extrinsics_src,
                                        intrinsics_src)
        if self.output_mode == "magic_opposite":
            rgb_dst = vis_frames(self.output_modality, "magic", dst_view_idx)
            reproject = None
        else:
            rgb_dst, reproject = self.synth_rgb(pcl_frames, self.output_modality,
                                                extrinsics_dst, intrinsics_dst,
                                                calc_reproject=True)
        return traj, rgb_src, rgb_dst, reproject

    def __getitem__(self, idx: int) -> Dict:
        tv, tcm = self.avail_frames, self.model_frames
        for retry_idx in range(self.max_retries):
            rng = np.random.default_rng((self.seed, int(idx), retry_idx))
            try:
                if self.next_example is not None:
                    scene_idx = int(self.next_example[0])
                    scene_dn = str(self.next_example[1])
                    frame_skip = int(self.next_example[2])
                    frame_start = int(self.next_example[3])
                    reverse = bool(self.next_example[4])
                    if scene_idx < 0:
                        scene_dn = "scene_000000"
                else:
                    if retry_idx >= 1 or self.force_shuffle:
                        idx2 = rng.integers(0, self.mock_dset_size)
                        idx = int((idx2 + idx) % self.mock_dset_size)
                    scene_idx = idx % self.num_scenes + self.start_idx
                    scene_dn = self.all_scene_dns[scene_idx - self.start_idx]
                    frame_skip = int(rng.integers(1, 3))
                    cover = frame_skip * (tcm - 1) + 1
                    frame_start = int(rng.integers(0, tv - cover))
                    reverse = bool(rng.random() < self.reverse_prob)

                fps = int(round(self.avail_fps / frame_skip))
                clip_frames = np.arange(tcm) * frame_skip + frame_start
                if scene_idx >= 0 and not (0 <= clip_frames[0] and clip_frames[-1] <= tv - 1):
                    raise ValueError(f"clip frames {clip_frames} outside 0..{tv - 1}")
                if reverse:
                    clip_frames = clip_frames[::-1].copy()

                traj, rgb_src, rgb_dst, reproject = self._load_clip(rng, scene_idx, scene_dn,
                                                                    clip_frames)
                (extrinsics_src, extrinsics_dst, _, _, readable_angles, src_view_idx,
                 dst_view_idx, motion_amount) = traj
                data = self.construct_dict(rng, rgb_src, rgb_dst, reproject, fps,
                                           readable_angles, src_view_idx, dst_view_idx,
                                           extrinsics_src, extrinsics_dst, motion_amount)
                break
            except Exception as e:
                common.log_retry("ParallelDomainSynthViewDataset", idx, retry_idx,
                                 self.max_retries, e)
                if retry_idx >= self.max_retries - 2:
                    raise
                time.sleep(min(0.2 + retry_idx * 0.02, 1.0))

        data["dset"] = np.array([2])
        data["idx"] = np.array([idx])
        data["scene_idx"] = np.array([scene_idx])
        data["frame_start"] = np.array([frame_start])
        data["frame_skip"] = np.array([frame_skip])
        data["clip_frames"] = np.asarray(clip_frames)
        return data


class ParallelDomainSynthViewModule:
    """The training and validation splits (the split JSON's lists, or
    scenes [0, train_videos) and [train_videos, train_videos + val_videos)
    of the directory) and their loaders."""

    def __init__(self, dset_root, train_videos, val_videos, test_videos, batch_size,
                 num_workers, shuffle=True, **kwargs):
        self.batch_size = int(batch_size)
        self.num_workers = int(num_workers)
        self.shuffle = shuffle
        self.train_dataset = ParallelDomainSynthViewDataset(dset_root, "train", 0,
                                                            train_videos, **kwargs)
        self.val_dataset = ParallelDomainSynthViewDataset(dset_root, "val", train_videos,
                                                          train_videos + val_videos, **kwargs)

    def train_dataloader(self):
        return PrefetchLoader(self.train_dataset, self.batch_size, shuffle=self.shuffle,
                              num_workers=self.num_workers)

    def val_dataloader(self):
        return PrefetchLoader(self.val_dataset, self.batch_size, shuffle=self.shuffle,
                              num_workers=self.num_workers)

"""Camera math and point-splat rendering for the training pairs (port of
gcd_tpu/data/geometry.py).

The camera and trajectory math is a numpy copy of gcd_tpu/data/geometry.py:
60-200 (Kubric's and ParallelDomain's cameras, the spherical conversions and
the spherical interpolation). `render_point_cloud` renders with the host C++ /
OpenMP splat (gcd_tpu_torch.native) and raises when that cannot be built.
`splat_points_to_image` and `blur_into_black` are plain PyTorch versions of
the same functions, float32 on any device, for the tests and callers that ask
for them by name: a per-pixel log-sum-exp shift (scatter max, then the
weighted sums by index_add_) of the reference's depth-exponential soft
z-buffer, and a separable Gaussian with reflect padding.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gcd_tpu_torch import native


def quaternion_to_rotation_matrix(q) -> np.ndarray:
    """(w, x, y, z) unit quaternion -> (3, 3) rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    n = np.sqrt(w * w + x * x + y * y + z * z)
    if n == 0:
        return np.eye(3)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def get_kubric_camera_matrices(metadata) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame normalised K and extrinsics, the Y / Z camera-axis columns
    negated."""
    t_total = metadata["scene"]["num_frames"]
    all_extrinsics = np.zeros((t_total, 4, 4), dtype=np.float32)
    all_intrinsics = np.zeros((t_total, 3, 3), dtype=np.float32)
    for t in range(t_total):
        rot_m = quaternion_to_rotation_matrix(np.asarray(metadata["camera"]["quaternions"][t]))
        ext = np.eye(4, dtype=np.float32)
        ext[0:3, 0:3] = rot_m
        ext[0:3, 3] = np.asarray(metadata["camera"]["positions"][t])
        ext[0:3, 1] *= -1.0
        ext[0:3, 2] *= -1.0
        all_extrinsics[t] = ext
        all_intrinsics[t] = np.abs(np.asarray(metadata["camera"]["K"], dtype=np.float32))
    return all_intrinsics, all_extrinsics


def get_pardom_intrinsics_matrix(d) -> np.ndarray:
    """A PD calibration entry's pixel-space K."""
    return np.array([[d["fx"], 0.0, d["cx"]], [0.0, d["fy"], d["cy"]], [0.0, 0.0, 1.0]],
                    dtype=np.float32)


def get_pardom_extrinsics_matrix(d) -> np.ndarray:
    """A PD calibration entry's (4, 4) camera-to-world matrix; the rotation
    as {qw, qx, qy, qz} or {w, x, y, z}, under `rotation` or `orientation`."""
    rot_q = d.get("rotation", d.get("orientation"))
    rot_t = d.get("translation", d.get("position"))
    if "qw" in rot_q:
        q = (rot_q["qw"], rot_q["qx"], rot_q["qy"], rot_q["qz"])
    else:
        q = (rot_q["w"], rot_q["x"], rot_q["y"], rot_q["z"])
    ext = np.eye(4, dtype=np.float32)
    ext[0:3, 0:3] = quaternion_to_rotation_matrix(q)
    ext[0:3, 3] = [rot_t["x"], rot_t["y"], rot_t["z"]]
    return ext


def get_pardom_camera_matrices(calibration):
    """(view names sorted, (V, 3, 3) pixel-space K, (V, 4, 4) extrinsics) of
    a PD scene's calibration, the velodyne views dropped."""
    view_names = []
    intr, extr = {}, {}
    for view_name, i_d, e_d in zip(calibration["names"], calibration["intrinsics"],
                                   calibration["extrinsics"]):
        if "velodyne" in view_name.lower():
            continue
        intr[view_name] = get_pardom_intrinsics_matrix(i_d)
        extr[view_name] = get_pardom_extrinsics_matrix(e_d)
        view_names.append(view_name)
    view_names = sorted(view_names)
    all_intrinsics = np.stack([intr[v] for v in view_names])
    all_extrinsics = np.stack([extr[v] for v in view_names])
    return view_names, all_intrinsics, all_extrinsics


def cartesian_from_spherical(spherical, deg2rad: bool = False) -> np.ndarray:
    azimuth, elevation, radius = spherical[..., 0], spherical[..., 1], spherical[..., 2]
    if deg2rad:
        azimuth = np.deg2rad(azimuth)
        elevation = np.deg2rad(elevation)
    x = radius * np.cos(elevation) * np.cos(azimuth)
    y = radius * np.cos(elevation) * np.sin(azimuth)
    z = radius * np.sin(elevation)
    return np.stack([x, y, z], axis=-1)


def spherical_from_cartesian(cartesian, rad2deg: bool = False) -> np.ndarray:
    """(..., 3) x, y, z -> azimuth, elevation (radians unless `rad2deg`),
    radius."""
    radius = np.linalg.norm(cartesian, ord=2, axis=-1)
    azimuth = np.arctan2(cartesian[..., 1], cartesian[..., 0])
    elevation = np.arctan2(cartesian[..., 2],
                           np.linalg.norm(cartesian[..., 0:2], ord=2, axis=-1))
    if rad2deg:
        azimuth = np.rad2deg(azimuth)
        elevation = np.rad2deg(elevation)
    return np.stack([azimuth, elevation, radius], axis=-1)


def interpolate_spherical(cart_start, cart_end, alpha: float) -> np.ndarray:
    """A point `alpha` of the way from cart_start to cart_end in spherical
    coordinates (float64), azimuth and elevation taking the short way round."""
    spher_start = spherical_from_cartesian(np.asarray(cart_start, dtype=np.float64))
    spher_end = spherical_from_cartesian(np.asarray(cart_end, dtype=np.float64))
    for i in (0, 1):
        if spher_end[i] - spher_start[i] > np.pi:
            spher_end[i] -= 2 * np.pi
        if spher_end[i] - spher_start[i] < -np.pi:
            spher_end[i] += 2 * np.pi
    spher_interp = spher_start * (1 - alpha) + spher_end * alpha
    return cartesian_from_spherical(spher_interp)


def extrinsics_from_look_at(camera_position, camera_look_at) -> np.ndarray:
    """(4, 4) float64 camera-to-world: columns right, down, forward."""
    camera_position = np.asarray(camera_position, dtype=np.float64)
    forward = np.asarray(camera_look_at, dtype=np.float64) - camera_position
    forward /= np.linalg.norm(forward)
    right = np.cross(np.array([0, 0, -1], dtype=np.float64), forward)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    rt = np.eye(4)
    rt[0:3, 0:3] = np.stack([right, down, forward], axis=1)
    rt[0:3, 3] = camera_position
    return rt


def spread_offsets(radius: int):
    """The neighbour offsets of the reference's spreaded_index_add."""
    left, right = radius // 2, (radius + 1) // 2
    return [(dx, dy) for dx in range(-left, right + 1) for dy in range(-left, right + 1)
            if not (dx == 0 and dy == 0)]


def splat_points_to_image(xyz: torch.Tensor, rgb: torch.Tensor, valid: torch.Tensor,
                          intrinsics: torch.Tensor, extrinsics: torch.Tensor, height: int,
                          width: int, spread_radius: int = 1, mode: str = "kubric"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render (N, 3) world points with (N, 3) colours in [0, 1] and an (N,)
    validity mask into (H, W, 3) with a depth-exponential soft z-buffer.
    mode "kubric": depth, strength 512; "pardom": sqrt depth clamped to 32,
    strength 256. Returns (image in [0, 1], exact zeros where no point
    landed; (H, W) sums of the shifted weights)."""
    xyz, rgb = xyz.float(), rgb.float()
    k, rt = intrinsics.float(), extrinsics.float()
    xyz_cam = (xyz - rt[0:3, 3]) @ rt[0:3, 0:3]
    uvw = xyz_cam @ k.T
    depth = xyz_cam[:, 2]
    uv = uvw[:, 0:2] / uvw[:, 2:3].abs().clamp_min(1e-12) * torch.sign(uvw[:, 2:3])
    uv_int = (uv + 0.5).to(torch.int64)  # truncation toward zero, as the reference
    u, v = uv_int[:, 0], uv_int[:, 1]
    mask = valid & (u >= 0) & (u < width) & (v >= 0) & (v < height) & (depth > 0.1)

    if mode == "pardom":
        strength = 256.0
        depth_eff = depth.clamp_min(0.0).sqrt().clamp(0.0, 32.0)
    else:
        strength = 512.0
        depth_eff = depth
    dmax = torch.where(mask, depth_eff, -torch.inf).max()
    neg = -(depth_eff / dmax * 2.0 - 1.0) * strength  # larger = closer

    hw = height * width
    offsets = [(0, 0)] + spread_offsets(spread_radius)
    idx, masks = [], []
    for dx, dy in offsets:
        ui, vi = u + dx, v + dy
        m = mask & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
        idx.append(torch.where(m, vi * width + ui, hw))  # slot hw takes the rest
        masks.append(m)
    idx_cat = torch.cat(idx)
    mask_cat = torch.cat(masks)
    neg_cat = neg.repeat(len(offsets))
    fac_cat = torch.cat([torch.full_like(neg, f)
                         for f in [1.0] + [0.02] * (len(offsets) - 1)])
    rgb_cat = rgb.repeat(len(offsets), 1)

    pix_max = torch.full((hw + 1,), -torch.inf, device=xyz.device).scatter_reduce(
        0, idx_cat, torch.where(mask_cat, neg_cat, -torch.inf), "amax")
    pix_max = torch.where(torch.isfinite(pix_max), pix_max, 0.0)
    w = torch.where(mask_cat, torch.exp(neg_cat - pix_max[idx_cat]) * fac_cat, 0.0)
    denom = torch.zeros(hw + 1, device=xyz.device).index_add_(0, idx_cat, w)
    numer = torch.zeros(hw + 1, 3, device=xyz.device).index_add_(0, idx_cat, w[:, None] * rgb_cat)
    denom = denom[:hw].reshape(height, width)
    numer = numer[:hw].reshape(height, width, 3)
    img = torch.where(denom[..., None] > 0.0,
                      numer / denom[..., None].clamp_min(1e-30), 0.0).clamp(0.0, 1.0)
    return img, denom


def gaussian_blur(img: torch.Tensor, kernel_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (H, W, C), reflect padding (torchvision's
    gaussian_blur), rows first."""
    x = torch.arange(kernel_size, dtype=torch.float32, device=img.device)
    g = torch.exp(-(x - (kernel_size - 1) / 2.0) ** 2 / (2.0 * sigma ** 2))
    g = g / g.sum()
    c, pad = img.shape[-1], kernel_size // 2
    out = img.permute(2, 0, 1)[None]
    out = F.conv2d(F.pad(out, (0, 0, pad, pad), mode="reflect"),
                   g.reshape(1, 1, kernel_size, 1).expand(c, 1, kernel_size, 1), groups=c)
    out = F.conv2d(F.pad(out, (pad, pad, 0, 0), mode="reflect"),
                   g.reshape(1, 1, 1, kernel_size).expand(c, 1, 1, kernel_size), groups=c)
    return out[0].permute(1, 2, 0)


def blur_into_black(img: torch.Tensor, kernel_size: int = 5, sigma: float = 1.5) -> torch.Tensor:
    """Leak the rendered colours into the zero (hole) pixels by a
    mask-normalised Gaussian blur, then a gentle 3x3 smoothing."""
    black = (img.sum(dim=-1) == 0.0)[..., None]
    blur_img = gaussian_blur(img, kernel_size, sigma)
    blur_mask = gaussian_blur((~black).float(), kernel_size, sigma)
    filled = torch.where(black, blur_img / blur_mask.clamp_min(1e-7), img)
    return gaussian_blur(filled, 3, 0.6)


def render_point_cloud(xyz: np.ndarray, rgb: np.ndarray, intrinsics: np.ndarray,
                       extrinsics: np.ndarray, height: int, width: int,
                       spread_radius: int = 1, mode: str = "kubric",
                       blur_kernel: int = 21) -> np.ndarray:
    """Splat (N, 3) points with (N, 3) colours in [0, 1] and fill the holes
    (sigma blur_kernel / 4) on the host: (H, W, 3) float32 in [0, 1]."""
    img = native.splat_points_native(xyz, rgb, intrinsics, extrinsics, height, width,
                                     spread_radius=spread_radius, mode=mode)
    return native.blur_into_black_native(img, kernel_size=blur_kernel)

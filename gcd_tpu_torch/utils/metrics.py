"""Evaluation metrics: PSNR, SSIM, their masked variants, mIoU, and the
per-frame x per-sample table of an evaluated clip (port of
gcd_tpu/utils/metrics.py, which gcd_tpu_torch cannot import).

numpy float64 throughout, with scipy.ndimage's Gaussian window (sigma 1.5,
truncated at 3.5 sigma; K1 = 0.01, K2 = 0.03), skimage's
structural_similarity with gaussian_weights=True, so the numbers are the JAX
package's. The RGBD-reprojection baseline splits a frame into visible
pixels (the baseline's sum over channels above 0.05) and occluded ones; a
metric over an empty mask is NaN, and NaNs are left out of the means.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _ssim_maps(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
               sigma: float = 1.5) -> np.ndarray:
    """Per-pixel SSIM map for 2D (grayscale) images, gaussian windowed."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    truncate = 3.5
    filt = lambda x: ndimage.gaussian_filter(x, sigma, truncate=truncate)

    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_a = filt(a)
    mu_b = filt(b)
    mu_aa = filt(a * a)
    mu_bb = filt(b * b)
    mu_ab = filt(a * b)

    # skimage's covariance normalisation is 1 with gaussian weights.
    va = mu_aa - mu_a * mu_a
    vb = mu_bb - mu_b * mu_b
    vab = mu_ab - mu_a * mu_b

    num = (2 * mu_a * mu_b + c1) * (2 * vab + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (va + vb + c2)
    return num / den


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM; channels averaged for (H, W, C) inputs."""
    if a.ndim == 3:
        return float(np.mean([
            _ssim_maps(a[..., c], b[..., c], data_range).mean()
            for c in range(a.shape[-1])
        ]))
    return float(_ssim_maps(a, b, data_range).mean())


def masked_ssim(a: np.ndarray, b: np.ndarray, mask: np.ndarray,
                data_range: float = 1.0) -> float:
    """SSIM restricted to a boolean mask: the SSIM map is computed densely,
    then averaged over the masked pixels only."""
    mask = mask.astype(bool)
    if mask.sum() == 0:
        return float("nan")
    if a.ndim == 3:
        maps = np.stack([
            _ssim_maps(a[..., c], b[..., c], data_range)
            for c in range(a.shape[-1])
        ], axis=-1)
        if mask.ndim == 2:
            mask = np.repeat(mask[..., None], maps.shape[-1], axis=-1)
        return float(maps[mask].mean())
    return float(_ssim_maps(a, b, data_range)[mask].mean())


def masked_psnr(a: np.ndarray, b: np.ndarray, mask: np.ndarray,
                data_range: float = 1.0) -> float:
    mask = mask.astype(bool)
    if mask.sum() == 0:
        return float("nan")
    if a.ndim == 3 and mask.ndim == 2:
        mask = np.repeat(mask[..., None], a.shape[-1], axis=-1)
    diff = (a.astype(np.float64) - b.astype(np.float64))[mask]
    mse = float(np.mean(diff**2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def rgb_to_class_ids(img01: np.ndarray, class_colors01: np.ndarray) -> np.ndarray:
    """Match each pixel to the nearest ontology color: (H, W, 3) in [0,1] ->
    (H, W) int ids, for the semantic head's mIoU."""
    flat = img01.reshape(-1, 3)
    d = ((flat[:, None, :] - class_colors01[None, :, :]) ** 2).sum(-1)
    return d.argmin(axis=1).reshape(img01.shape[:2])


def miou(pred_ids: np.ndarray, gt_ids: np.ndarray,
         num_classes: Optional[int] = None,
         present_only: bool = True) -> float:
    """Mean intersection-over-union over classes (present in GT by default)."""
    if num_classes is None:
        num_classes = int(max(pred_ids.max(), gt_ids.max())) + 1
    ious = []
    for c in range(num_classes):
        gt_c = gt_ids == c
        pr_c = pred_ids == c
        union = np.logical_or(gt_c, pr_c).sum()
        if union == 0:
            continue
        if present_only and gt_c.sum() == 0:
            continue
        ious.append(np.logical_and(gt_c, pr_c).sum() / union)
    return float(np.mean(ious)) if ious else float("nan")


def video_metrics(pred: np.ndarray, gt: np.ndarray,
                  reproject: Optional[np.ndarray] = None,
                  mask_threshold: float = 0.05) -> Dict[str, float]:
    """Per-clip metrics: frame-averaged PSNR/SSIM, plus visible/occluded
    splits using the RGBD-reprojection hole mask (pixels the source view
    could not cover are 'occluded')."""
    t = pred.shape[0]
    out: Dict[str, list] = {"psnr": [], "ssim": []}
    if reproject is not None:
        for k in ("psnr_visible", "psnr_occluded", "ssim_visible",
                  "ssim_occluded"):
            out[k] = []
    for i in range(t):
        out["psnr"].append(psnr(pred[i], gt[i]))
        out["ssim"].append(ssim(pred[i], gt[i]))
        if reproject is not None:
            # reproject in [0,1]; holes are (near-)black after splat+blur.
            vis_mask = reproject[i].sum(-1) > mask_threshold
            out["psnr_visible"].append(masked_psnr(pred[i], gt[i], vis_mask))
            out["psnr_occluded"].append(masked_psnr(pred[i], gt[i], ~vis_mask))
            out["ssim_visible"].append(masked_ssim(pred[i], gt[i], vis_mask))
            out["ssim_occluded"].append(masked_ssim(pred[i], gt[i], ~vis_mask))
    return {k: float(np.nanmean(v)) for k, v in out.items()}


def sample_diversity(samples: Sequence[np.ndarray]) -> float:
    """Std across repeated samples, averaged over pixels."""
    if len(samples) < 2:
        return 0.0
    stack = np.stack(samples)
    return float(stack.std(axis=0).mean())


def clip_metrics(pred_samples: Sequence[np.ndarray], gt: np.ndarray,
                 reproject: Optional[np.ndarray] = None,
                 mask_threshold: float = 0.05):
    """Per-frame x per-sample metrics of an evaluated clip. All videos
    (T, H, W, 3) float32 in [0, 1].

    Returns (metrics_dict, uncertainty):
      frame_psnr/frame_ssim              (S, T)
      frame_{psnr,ssim}_{vis,occ}        (S, T)   when reproject is given
      frame_diversity[_vis,_occ]         (T,)
      mean_* scalars per sample          (S,) and mean_diversity float
      uncertainty                        (T, H, W) pixel std across samples
    """
    s = len(pred_samples)
    assert s >= 1
    stack = np.stack(pred_samples)  # (S, T, H, W, 3)
    t = gt.shape[0]

    if reproject is not None:
        # Holes are (near-)black after the splat and blur: a small
        # threshold rather than an exact zero test.
        vis_mask = reproject.sum(-1) > mask_threshold  # (T, H, W)
        occ_mask = ~vis_mask

    md = {}
    md["frame_psnr"] = np.array(
        [[psnr(p[i], gt[i]) for i in range(t)] for p in pred_samples])
    md["frame_ssim"] = np.array(
        [[ssim(p[i], gt[i]) for i in range(t)] for p in pred_samples])
    if reproject is not None:
        md["frame_psnr_vis"] = np.array(
            [[masked_psnr(p[i], gt[i], vis_mask[i]) for i in range(t)]
             for p in pred_samples])
        md["frame_psnr_occ"] = np.array(
            [[masked_psnr(p[i], gt[i], occ_mask[i]) for i in range(t)]
             for p in pred_samples])
        md["frame_ssim_vis"] = np.array(
            [[masked_ssim(p[i], gt[i], vis_mask[i]) for i in range(t)]
             for p in pred_samples])
        md["frame_ssim_occ"] = np.array(
            [[masked_ssim(p[i], gt[i], occ_mask[i]) for i in range(t)]
             for p in pred_samples])

    # Pixelwise std across samples, averaged over channels.
    uncertainty = (np.nanmean(np.std(stack, axis=0), axis=-1)
                   if s >= 2 else np.zeros(gt.shape[:-1], np.float32))
    md["frame_diversity"] = np.nanmean(uncertainty, axis=(1, 2))
    if reproject is not None:
        md["frame_diversity_vis"] = np.array([
            float(np.nanmean(np.std(stack[:, i][:, vis_mask[i]], axis=0)))
            if vis_mask[i].any() else np.nan for i in range(t)])
        md["frame_diversity_occ"] = np.array([
            float(np.nanmean(np.std(stack[:, i][:, occ_mask[i]], axis=0)))
            if occ_mask[i].any() else np.nan for i in range(t)])

    for key in list(md):
        if key.startswith("frame_"):
            md["mean_" + key[len("frame_"):]] = np.nanmean(md[key], axis=-1)
    md["mean_diversity"] = float(np.nanmean(md["frame_diversity"]))
    return md, uncertainty

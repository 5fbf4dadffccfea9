"""The evaluation galleries (port of scripts/galleries.py): per example,
annotated canvases of the inputs, the target, the samples, their error
maps, latent PCA, diversity and uncertainty heatmaps and the RGBD
reprojection baseline, one layout a file:

  rich1  Input, Target | Output 1, Output 2 [| Output 3, Output 4]
  rich2  Input | Output 1                      (the "io" strip)
  rich3  rich1's first two columns | Error 1, Error 2
  rich4  rich1's first two columns | Latent PCA 1, 2   (opt-in)
  rich5  Input, Target | Delta, Uncertainty heatmaps   (needs S >= 2)
  rich6  Input, Target | Output 1, Reprojection        (needs reproject)
  rich7  Input, Target | Reproj+Error, Reproj+Uncert   (opt-in)

Every video is (T, H, W, 3) float32 in [0, 1]; the metrics are
utils/metrics.py clip_metrics' per-sample x per-frame arrays. Each panel
has a header band of BAND rows whose label is drawn by utils/draw.py
draw_text (cv2.putText's glyphs); the heatmaps take utils/draw.py's copy of
matplotlib's `magma`. A layout is written by eval_utils.write_video_and_frames
as `{tag}_{SUFFIX}.npz` + `.png` strip (the port's departure: no video
codec on the machines it runs on, so no MP4).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from gcd_tpu_torch import eval_utils
from gcd_tpu_torch.utils.draw import colormap, draw_text

# Header band height above each row of panels; labels sit at y = BAND - 14.
BAND = 40
LAYOUTS = ("rich1", "rich2", "rich3", "rich4", "rich5", "rich6", "rich7")
DEFAULT_LAYOUTS = ("rich1", "rich2", "rich3", "rich5", "rich6")
# Layout -> output-file suffix.
SUFFIX = {"rich1": "gal", "rich2": "io", "rich3": "err", "rich4": "lat",
          "rich5": "div", "rich6": "proj", "rich7": "projx"}


def _magma(x01: np.ndarray) -> np.ndarray:
    """(...) in [0, 1] -> (..., 3) float32 magma RGB."""
    return colormap("magma", np.clip(x01, 0.0, 1.0)).astype(np.float32)


def _label(band: np.ndarray, text: str) -> np.ndarray:
    return draw_text(band, text, org=(5, BAND - 14))


def _panel(canvas: np.ndarray, row: int, col: int, hp: int, wp: int,
           img: np.ndarray, label: str) -> None:
    """One (hp, wp, 3) image and its header label on the canvas grid."""
    y0 = row * (hp + BAND) + BAND
    x0 = col * wp
    canvas[y0:y0 + hp, x0:x0 + wp] = img
    canvas[y0 - BAND:y0, x0:x0 + wp] = _label(canvas[y0 - BAND:y0, x0:x0 + wp], label)


def _grid(hp: int, wp: int, rows: int, cols: int) -> np.ndarray:
    return np.zeros((rows * (hp + BAND), cols * wp, 3), dtype=np.float32)


def parse_layouts(spec: str) -> tuple:
    """--galleries: a comma list of rich1..rich7, or 'all'."""
    if spec == "all":
        return LAYOUTS
    names = tuple(g for g in spec.split(",") if g)
    unknown = [g for g in names if g not in LAYOUTS]
    if unknown:
        raise ValueError(f"--galleries: unknown layouts {unknown}; choose from {LAYOUTS}")
    return names


def controls_friendly_title(control: Dict) -> str:
    """The camera move's tag for the Target header."""
    ss = control.get("spherical_start")
    se = control.get("spherical_end")
    if ss is not None and se is not None:
        d_az, d_el, d_r = (se[0] - ss[0]), (se[1] - ss[1]), (se[2] - ss[2])
        if any(abs(v) > 1e-9 for v in (d_az, d_el, d_r)):
            return f"A {d_az:.1f} E {d_el:.1f} R {d_r:.1f}"
    return f"FS {control.get('frame_start', 0)}"


def create_visualizations(
        input_rgb: np.ndarray,
        gt_rgb: np.ndarray,
        pred_samples_rgb: List[np.ndarray],
        metrics: Dict[str, np.ndarray],
        uncertainty: Optional[np.ndarray] = None,
        reproject_rgb: Optional[np.ndarray] = None,
        pred_samples_latent: Optional[List[np.ndarray]] = None,
        model_name: str = "gcd_tpu_torch",
        target_title: str = "Target",
        enable: tuple = DEFAULT_LAYOUTS,
) -> Dict[str, np.ndarray]:
    """The enabled layouts, {name: (T + 3, Hc, Wc, 3)}: each canvas a frame,
    the first frame once more at the start and the last twice at the end
    (the loop pause)."""
    t, hp, wp, _ = input_rgb.shape
    s = len(pred_samples_rgb)
    fp, fs = metrics["frame_psnr"], metrics["frame_ssim"]
    fdiv = metrics.get("frame_diversity")

    error_rgb = None
    if s >= 1:
        error_rgb = np.abs(gt_rgb - pred_samples_rgb[0]).mean(-1)
    uncertainty_rgb = None
    if uncertainty is not None and s >= 2:
        uncertainty_rgb = _magma(np.clip(uncertainty * 3.0, 0.0, 1.0))

    latent_vis = None
    if pred_samples_latent and "rich4" in enable:
        # PCA over all samples jointly, so that the panels compare.
        lat = np.stack(pred_samples_latent)  # (S, T, Hl, Wl, C)
        joint = eval_utils.quick_pca(lat.reshape(-1, *lat.shape[2:]))
        joint = joint.reshape(*lat.shape[:2], *joint.shape[1:])
        f = hp // joint.shape[2]
        latent_vis = np.repeat(np.repeat(joint, f, axis=2), f, axis=3)

    frames: Dict[str, list] = {k: [] for k in LAYOUTS}
    for i in range(t):
        # Every layout is cut from the rich1 canvas; it is kept when rich1
        # is enabled.
        cols1 = 2 if s <= 2 else 3
        c1 = _grid(hp, wp, 2, cols1)
        _panel(c1, 0, 0, hp, wp, input_rgb[i], f"Input (Frame {i})")
        _panel(c1, 1, 0, hp, wp, gt_rgb[i], target_title)
        for j in range(min(s, (cols1 - 1) * 2)):
            _panel(c1, j % 2, 1 + j // 2, hp, wp, pred_samples_rgb[j][i],
                   f"Output {j + 1} (PSNR {fp[j, i]:.2f}, SSIM {fs[j, i]:.3f})")
        if "rich1" in enable:
            frames["rich1"].append(c1)

        if s >= 1 and "rich2" in enable:
            c2 = c1[0:hp + BAND, 0:wp * 2].copy()
            c2[0:BAND, wp:] = 0.0
            c2[0:BAND, wp:] = _label(c2[0:BAND, wp:], f"Output ({model_name})")
            frames["rich2"].append(c2)

        if s >= 1 and "rich3" in enable:
            c3 = _grid(hp, wp, 2, 3)
            c3[:, 0:wp * 2] = c1[:, 0:wp * 2]
            _panel(c3, 0, 2, hp, wp, np.abs(gt_rgb[i] - pred_samples_rgb[0][i]), "Error 1")
            if s >= 2:
                _panel(c3, 1, 2, hp, wp, np.abs(gt_rgb[i] - pred_samples_rgb[1][i]), "Error 2")
            frames["rich3"].append(c3)

        if latent_vis is not None:
            c4 = _grid(hp, wp, 2, 3)
            c4[:, 0:wp * 2] = c1[:, 0:wp * 2]
            _panel(c4, 0, 2, hp, wp, latent_vis[0][i], "Latent 1")
            if s >= 2:
                _panel(c4, 1, 2, hp, wp, latent_vis[1][i], "Latent 2")
            frames["rich4"].append(c4)

        if s >= 2 and uncertainty_rgb is not None and "rich5" in enable:
            delta = np.abs(pred_samples_rgb[0][i] - pred_samples_rgb[1][i]) * 2.0
            c5 = _grid(hp, wp, 2, 2)
            c5[:, 0:wp] = c1[:, 0:wp]
            _panel(c5, 0, 1, hp, wp, pred_samples_rgb[0][i] * 0.3 + delta * 0.8,
                   f"Delta (Div {fdiv[i]:.3f})")
            _panel(c5, 1, 1, hp, wp, pred_samples_rgb[1][i] * 0.3 + uncertainty_rgb[i] * 0.8,
                   f"Uncertainty (Div {fdiv[i]:.3f})")
            frames["rich5"].append(c5)

        if s >= 1 and reproject_rgb is not None and "rich6" in enable:
            fpo, fso = metrics["frame_psnr_occ"], metrics["frame_ssim_occ"]
            fpv, fsv = metrics["frame_psnr_vis"], metrics["frame_ssim_vis"]
            c6 = _grid(hp, wp, 2, 2)
            c6[:, 0:wp] = c1[:, 0:wp]
            _panel(c6, 0, 1, hp, wp, pred_samples_rgb[0][i],
                   f"Output 1 (PSNR Occ {fpo[0, i]:.2f}, SSIM Occ {fso[0, i]:.2f})")
            _panel(c6, 1, 1, hp, wp, reproject_rgb[i],
                   f"Reproj (PSNR Vis {fpv[0, i]:.2f}, SSIM Vis {fsv[0, i]:.2f})")
            frames["rich6"].append(c6)

        if ("rich7" in enable and reproject_rgb is not None and s >= 2
                and error_rgb is not None and uncertainty_rgb is not None):
            fpo, fso = metrics["frame_psnr_occ"], metrics["frame_ssim_occ"]
            err_map = _magma(error_rgb[i])
            c7 = _grid(hp, wp, 2, 3)
            c7[:, 0:wp * 2] = c1[:, 0:wp * 2]
            _panel(c7, 0, 2, hp, wp, reproject_rgb[i] * 0.4 + err_map * 0.8,
                   f"Proj+Error (PSNR Occ {fpo[0, i]:.2f}, SSIM Occ {fso[0, i]:.2f})")
            _panel(c7, 1, 2, hp, wp, reproject_rgb[i] * 0.4 + uncertainty_rgb[i] * 0.8,
                   f"Proj+Uncert (Div {fdiv[i]:.3f})")
            frames["rich7"].append(c7)

    out: Dict[str, np.ndarray] = {}
    for name, fr in frames.items():
        if not fr or name not in enable:
            continue
        padded = [fr[0]] + fr + [fr[-1]] * 2
        out[name] = np.clip(np.stack(padded), 0.0, 1.0)
    return out


def save_visualizations(vis: Dict[str, np.ndarray], out_dp: str, tag: str,
                        frame_rate: int = 8) -> None:
    """Each layout as `{tag}_{SUFFIX}` (eval_utils.write_video_and_frames),
    played at (6 + frame_rate) // 2 frames/s, at least 2."""
    fps = max((6 + frame_rate) // 2, 2)
    for name, video in vis.items():
        eval_utils.write_video_and_frames(out_dp, f"{tag}_{SUFFIX[name]}", video, fps=fps)

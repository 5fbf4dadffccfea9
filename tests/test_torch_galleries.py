"""The galleries and the images they draw on (gcd_tpu_torch/galleries.py,
utils/draw.py, the PD depth visualisation, eval_utils.quick_pca, the test
entry's --galleries) against the JAX package's (scripts/galleries.py,
scripts/eval_utils.py, gcd_tpu/data/common.py), which use the test host's
matplotlib 3.10.8 and cv2 5.0.0:
* the plasma and magma tables equal matplotlib's colours bit for bit at
  4096 points in [0, 1], both ends, outside [0, 1] and at NaN;
* each printable character alone equal to cv2.putText's pixels, at several
  origins (one glyph phase: every advance of the font at scale 0.5 is a
  whole pixel), and every label the galleries draw, in bands of the
  galleries' widths and wider, equal to cv2's (the tolerance measured: max
  abs 0, no band pixel differs), also over random backgrounds;
* quick_pca within 1e-6 of JAX's; each layout rich1-rich7 from the same
  inputs equal to JAX's create_visualizations bit for bit (image areas and
  header bands);
* the test entry on the tiny config with the default --galleries writing
  each default layout's files.
"""

import os

import cv2
import matplotlib
import numpy as np
import pytest
import torch

from gcd_tpu.data import common as jcommon
from gcd_tpu.utils import metrics as jmetrics
from gcd_tpu_torch import eval_utils, galleries
from gcd_tpu_torch import test as test_entry
from gcd_tpu_torch.data import common
from gcd_tpu_torch.data.fake import make_kubric_root
from gcd_tpu_torch.data.png import read_png
from gcd_tpu_torch.utils.config import apply_dotlist, load_config, save_config
from gcd_tpu_torch.utils.draw import colormap, draw_text
from scripts import eval_utils as jeval_utils
from scripts import galleries as jgalleries
from tests.torch_port_helpers import TINY_CONFIG

T, H, W, S = 3, 32, 48, 2
ORG = (5, galleries.BAND - 14)
# What the galleries draw: every format of their labels, with the widest
# numbers, a Target title with a trajectory tag and a long model name.
LABELS = ["Input (Frame 0)", "Input (Frame 13)", "Target (A -123.4 E 45.6 R -2.5)",
          "Target (FS 17)", "Target", "Output 1 (PSNR 12.34, SSIM 0.567)",
          "Output 2 (PSNR nan, SSIM -0.012)", "Output (gcd_tpu_torch_kubric_max90_ema_step_100000)",
          "Error 1", "Error 2", "Latent 1", "Latent 2", "Delta (Div 0.123)",
          "Uncertainty (Div 1.000)", "Output 1 (PSNR Occ 23.45, SSIM Occ 0.78)",
          "Reproj (PSNR Vis 9.87, SSIM Vis 0.12)", "Proj+Error (PSNR Occ 23.45, SSIM Occ 0.78)",
          "Proj+Uncert (Div 0.045)", "".join(chr(c) for c in range(32, 127))]


def _cv2_text(img01, text, org):
    return jeval_utils.draw_text(img01, text, org=org, scale=0.5)


@pytest.mark.parametrize("name", ["plasma", "magma"])
def test_colour_tables_are_matplotlibs(name):
    x = np.concatenate([np.linspace(0.0, 1.0, 4096), [0.0, 1.0, -0.5, 1.5, np.nan]])
    for xs in (x, x.astype(np.float32)):
        got = colormap(name, xs)
        want = matplotlib.colormaps[name](xs)[..., :3]
        assert got.dtype == want.dtype and np.array_equal(got, want)
    ints = np.array([-3, 0, 17, 255, 256, 1000])
    assert np.array_equal(colormap(name, ints), matplotlib.colormaps[name](ints)[..., :3])


def test_depth_is_jaxs():
    rng = np.random.default_rng(0)
    for depth in (rng.uniform(0.5, 120.0, (48, 64)).astype(np.float32),
                  np.full((8, 8), 3.0, np.float32)):
        got = common.visualize_pardom_frame(depth, "depth", "camera0", None)
        want = jcommon.visualize_pardom_frame(depth, "depth", "camera0", None)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


def test_each_glyph_is_cv2s():
    for code in range(32, 127):
        c = chr(code)
        for org in ((0, 20), (7, 26), (30, 5)):
            band = np.zeros((40, 60, 3), np.float32)
            assert np.array_equal(draw_text(band, c, org=org), _cv2_text(band, c, org)), (c, org)
        (w2, _), _ = cv2.getTextSize(c + c, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        assert (w2 - 1) % 2 == 0  # a whole-pixel advance: one phase


@pytest.mark.parametrize("width", [W, 384, 1000])
def test_gallery_labels_are_cv2s(width):
    rng = np.random.default_rng(width)
    differ = 0
    for label in LABELS:
        for band in (np.zeros((galleries.BAND, width, 3), np.float32),
                     rng.uniform(size=(galleries.BAND, width, 3)).astype(np.float32)):
            got, want = draw_text(band, label, org=ORG), _cv2_text(band, label, ORG)
            assert got.dtype == want.dtype and got.shape == want.shape
            differ += int((got != want).sum())
    assert differ == 0
    with pytest.raises(ValueError, match="scale"):
        draw_text(np.zeros((40, 40, 3), np.float32), "x", scale=1.0)


def test_quick_pca_is_jaxs():
    lat = np.random.default_rng(1).normal(size=(2 * T, 4, 6, 4)).astype(np.float32)
    np.testing.assert_allclose(eval_utils.quick_pca(lat), jeval_utils.quick_pca(lat),
                               rtol=0.0, atol=1e-6)


@pytest.fixture(scope="module")
def gallery_inputs():
    rng = np.random.default_rng(2)

    def video():
        return rng.uniform(size=(T, H, W, 3)).astype(np.float32)

    gt, reproject = video(), video()
    reproject[:, :, :W // 2] = 0.0  # holes: occluded pixels
    samples = [np.clip(gt + 0.2 * rng.normal(size=gt.shape), 0, 1).astype(np.float32)
               for _ in range(S)]
    metrics, uncertainty = jmetrics.clip_metrics(samples, gt, reproject)
    latents = [rng.normal(size=(T, H // 8, W // 8, 4)).astype(np.float32) for _ in range(S)]
    control = {"spherical_start": [10.0, 20.0, 15.0], "spherical_end": [52.3, 31.5, 14.0]}
    return dict(input_rgb=video(), gt_rgb=gt, pred_samples_rgb=samples, metrics=metrics,
                uncertainty=uncertainty, reproject_rgb=reproject, pred_samples_latent=latents,
                model_name="gcd_tpu_torch_kubric_max90_ema_step_100000",
                target_title=f"Target ({galleries.controls_friendly_title(control)})")


@pytest.mark.parametrize("samples", [1, S])
def test_layouts_are_jaxs(gallery_inputs, samples):
    kw = dict(gallery_inputs, pred_samples_rgb=gallery_inputs["pred_samples_rgb"][:samples],
              pred_samples_latent=gallery_inputs["pred_samples_latent"][:samples])
    kw["metrics"] = {k: v[:samples] if np.ndim(v) == 2 else v for k, v in kw["metrics"].items()}
    got = galleries.create_visualizations(**kw, enable=galleries.LAYOUTS)
    want = jgalleries.create_visualizations(**kw, enable=galleries.LAYOUTS)
    assert sorted(got) == sorted(want)
    assert len(got) == (7 if samples == S else 5)  # rich5 and rich7 need two samples
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert got[name].shape[0] == T + 3
        assert got[name].dtype == want[name].dtype
        assert np.array_equal(got[name], want[name]), name
    assert galleries.SUFFIX == jgalleries.SUFFIX
    assert galleries.controls_friendly_title({"frame_start": 4}) == \
        jgalleries.controls_friendly_title({"frame_start": 4})


def test_parse_layouts():
    assert galleries.parse_layouts("all") == galleries.LAYOUTS
    assert galleries.parse_layouts("rich1,rich4") == ("rich1", "rich4")
    with pytest.raises(ValueError, match="rich9"):
        galleries.parse_layouts("rich1,rich9")


def test_test_entry_writes_the_default_galleries(tmp_path):
    root = str(tmp_path / "root")
    make_kubric_root(root)
    cfg = apply_dotlist(load_config(TINY_CONFIG), [f"data.params.dset_root={root}/data",
                                                   f"data.params.pcl_root={root}/pcl"])
    config = str(tmp_path / "tiny.yaml")
    save_config(cfg, config)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        test_entry.main(["--device", "cpu", "--config_path", config, "--input", "0",
                         "--generate_controls", "--samples_per_scene", "1", "--num_samples",
                         str(S), "--num_frames", str(T), "--frame_width", str(W),
                         "--frame_height", str(H), "--num_steps", "2", "--decoding_t", str(T),
                         "--output", str(tmp_path / "out")])
    finally:
        torch.set_num_threads(threads)
    out = str(tmp_path / "out" / "random")
    cols = {"gal": 2, "io": 2, "err": 3, "div": 2, "proj": 2}
    rows = {"io": 1}
    for suffix in ("gal", "io", "err", "div", "proj"):
        with np.load(os.path.join(out, f"0_sample_00_{suffix}.npz")) as z:
            frames = z["frames"]
        shape = (T + 3, rows.get(suffix, 2) * (H + galleries.BAND), cols[suffix] * W, 3)
        assert frames.shape == shape and frames.dtype == np.uint8, suffix
        assert read_png(os.path.join(out, f"0_sample_00_{suffix}.png")).shape[0] == shape[1]
    assert not os.path.exists(os.path.join(out, "0_sample_00_lat.npz"))

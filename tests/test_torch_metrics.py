"""The port's evaluation metrics (gcd_tpu_torch/utils/metrics.py) against
the JAX package's (gcd_tpu/utils/metrics.py) on seeded numpy frames: PSNR,
SSIM, their masked variants on empty, full and random masks, the class ids
and mIoU, the clip means, the sample diversity and clip_metrics key for
key. Both are float64 numpy: held to 1e-10, NaN where the JAX package gives
NaN, inf where it gives inf.
"""

import numpy as np
import pytest

from gcd_tpu.utils import metrics as jmetrics
from gcd_tpu_torch.utils import metrics
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-10
T, H, W = 3, 24, 20


def _same(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0.0, atol=TOL, equal_nan=True)


def _frames(seed, n=T):
    rng = np.random.default_rng(seed)
    return rng.random((n, H, W, 3)).astype(np.float32)


def _reproject(seed):
    """A baseline with black holes (sums below 0.05) in about a third of
    the pixels, and frame 0 hole-free."""
    rng = np.random.default_rng(seed)
    rep = rng.random((T, H, W, 3)).astype(np.float32) * 0.5 + 0.1
    holes = rng.random((T, H, W)) < 0.35
    holes[0] = False
    rep[holes] = 0.0
    return rep


@pytest.mark.parametrize("channels", [None, 3])
def test_psnr_and_ssim(channels):
    a, b = _frames(0)[0], _frames(1)[0]
    if channels is None:
        a, b = a[..., 0], b[..., 0]
    _same(metrics.psnr(a, b), jmetrics.psnr(a, b))
    _same(metrics.ssim(a, b), jmetrics.ssim(a, b))
    a2, b2 = a.reshape(H, W, -1)[..., 0], b.reshape(H, W, -1)[..., 0]
    _same(metrics._ssim_maps(a2, b2), jmetrics._ssim_maps(a2, b2))
    assert metrics.psnr(a, a) == jmetrics.psnr(a, a) == float("inf")


@pytest.mark.parametrize("mask", ["empty", "full", "random"])
@pytest.mark.parametrize("channels", [None, 3])
def test_masked_psnr_and_ssim(mask, channels):
    a, b = _frames(2)[0], _frames(3)[0]
    if channels is None:
        a, b = a[..., 0], b[..., 0]
    m = {"empty": np.zeros((H, W), bool), "full": np.ones((H, W), bool),
         "random": np.random.default_rng(4).random((H, W)) < 0.4}[mask]
    for fn in ("masked_psnr", "masked_ssim"):
        got, want = getattr(metrics, fn)(a, b, m), getattr(jmetrics, fn)(a, b, m)
        _same(got, want)
        assert np.isnan(got) == (mask == "empty")
    if mask == "full":
        _same(metrics.masked_psnr(a, b, m), metrics.psnr(a, b))
        _same(metrics.masked_ssim(a, b, m), metrics.ssim(a, b))


def test_class_ids_and_miou():
    rng = np.random.default_rng(5)
    palette = rng.random((6, 3))
    img = np.clip(palette[rng.integers(0, 6, (H, W))] + rng.normal(0, 0.05, (H, W, 3)), 0, 1)
    ids = metrics.rgb_to_class_ids(img, palette)
    assert np.array_equal(ids, jmetrics.rgb_to_class_ids(img, palette))
    gt = rng.integers(0, 6, (H, W))
    gt[gt == 5] = 4  # a class absent from the ground truth
    for kwargs in ({}, {"num_classes": 8}, {"present_only": False}):
        _same(metrics.miou(ids, gt, **kwargs), jmetrics.miou(ids, gt, **kwargs))
    assert np.isnan(metrics.miou(np.zeros((2, 2), int), np.zeros((2, 2), int), num_classes=0))


@pytest.mark.parametrize("with_reproject", [False, True])
def test_video_metrics(with_reproject):
    pred, gt = _frames(6), _frames(7)
    rep = _reproject(8) if with_reproject else None
    got, want = metrics.video_metrics(pred, gt, rep), jmetrics.video_metrics(pred, gt, rep)
    assert sorted(got) == sorted(want)
    assert len(got) == (6 if with_reproject else 2)
    for k in want:
        _same(got[k], want[k])


@pytest.mark.parametrize("n_samples", [1, 2, 3])
def test_sample_diversity(n_samples):
    samples = [_frames(10 + s) for s in range(n_samples)]
    _same(metrics.sample_diversity(samples), jmetrics.sample_diversity(samples))


@pytest.mark.parametrize("n_samples,with_reproject", [(1, False), (2, False), (2, True),
                                                      (3, True)])
def test_clip_metrics_key_for_key(n_samples, with_reproject):
    samples = [_frames(20 + s) for s in range(n_samples)]
    gt = _frames(30)
    rep = _reproject(31) if with_reproject else None
    got, got_unc = metrics.clip_metrics(samples, gt, rep)
    want, want_unc = jmetrics.clip_metrics(samples, gt, rep)
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k])
    _same(got_unc, want_unc)
    if with_reproject:
        assert got["frame_psnr_occ"].shape == (n_samples, T)
        assert np.isnan(got["frame_psnr_occ"][:, 0]).all()  # frame 0 has no hole
        assert np.isfinite(got["frame_ssim_vis"]).all()

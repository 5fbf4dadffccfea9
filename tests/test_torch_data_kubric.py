"""The port's Kubric-4D data pipeline on the CPU against the JAX package:
the synthetic root, the native splat, the plain splat and blur, the resize,
the dataset's items (with the RGBD-reprojection baseline, the spherical
start and end overrides, the validation split) and the loader's order and
batches.

The root is the tiny one of configs/smoke_kubric_tiny.yaml (4 views of 3,000
points a frame, 52x36 renders resized to 48x32). Both datasets render with
their native splat, built from the same source with the same flags, so the
images agree bit for bit before the resize; the port resizes with PyTorch's
bilinear interpolation where the JAX package calls cv2.resize, which differ
in the order of fp32 sums (~1e-7 here): floats are held to 1e-5 absolute.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from gcd_tpu import native as jnative
from gcd_tpu.data import geometry as jgeometry
from gcd_tpu.data import kubric as jkubric
from gcd_tpu.data.common import process_image as jprocess_image
from gcd_tpu.data.loader import PrefetchLoader as JPrefetchLoader
from gcd_tpu_torch import native
from gcd_tpu_torch.data import geometry
from gcd_tpu_torch.data.common import process_image
from gcd_tpu_torch.data.fake import make_kubric_root
from gcd_tpu_torch.data.kubric import KubricSynthViewDataset, KubricSynthViewModule
from gcd_tpu_torch.data.loader import PrefetchLoader, batch_to_device, collate_fn
from gcd_tpu_torch.utils.config import load_config
from scripts import make_fake_data
from tests.torch_port_helpers import TINY_CONFIG

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    PyTorch's thread pool oversubscribed by them slows these tiny ops
    several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def jax_native_splat():
    """The JAX package builds its splat library beside its source at first
    use, and another test process may be writing it at the same moment:
    wait for a library that loads, so that its dataset renders natively."""
    for _ in range(30):
        if jnative.native_available():
            return
        jnative._load_failed = False
        time.sleep(1.0)
    pytest.fail("the JAX package's native splat library does not load")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("kubric_port"))
    make_kubric_root(path)
    return path


def _dataset_kwargs(root):
    params = dict(load_config(TINY_CONFIG)["data"]["params"])
    params.update(dset_root=os.path.join(root, "data"), pcl_root=os.path.join(root, "pcl"))
    for key in ("train_videos", "val_videos", "test_videos", "batch_size", "num_workers"):
        params.pop(key)
    return dict(params, start_idx=0, end_idx=1)


def _assert_same_items(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (int, np.integer)):
            assert g == w, k
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            assert np.abs(g - w).max() <= TOL, (k, np.abs(g - w).max())
        else:
            assert np.array_equal(g, w), k


def test_fake_root_is_make_fake_data_s(root, tmp_path):
    """The same files and the same tensors as scripts/make_fake_data.py."""
    make_fake_data.make_kubric_root(str(tmp_path))
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), str(tmp_path))
                           for d, _, fs in os.walk(str(tmp_path)) for f in fs)
    assert len(files) == 21
    for f in files:
        a, b = os.path.join(root, f), os.path.join(str(tmp_path), f)
        if f.endswith(".json"):
            assert open(a).read() == open(b).read()
        else:
            for x, y in zip(torch.load(a, weights_only=True), torch.load(b, weights_only=True)):
                assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("mode", ["kubric", "pardom"])
def test_native_splat_is_bit_identical_to_jax_s(mode):
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(3000, 3)).astype(np.float32) * (9.0 if mode == "pardom" else 1.5)
    xyz[:, 2] += 1.0
    rgb = rng.random((3000, 3)).astype(np.float32)
    k = np.array([[45.5, 0, 26], [0, 47.25, 18], [0, 0, 1]], np.float32)
    e = geometry.extrinsics_from_look_at([12.0, 3.0, 4.0], [0.0, 0.0, 1.0]).astype(np.float32)
    img = native.splat_points_native(xyz, rgb, k, e, 36, 52, mode=mode)
    jimg = jnative.splat_points_native(xyz, rgb, k, e, 36, 52, mode=mode)
    assert np.array_equal(img, jimg)
    assert 0.2 < (img.sum(-1) > 0).mean() < 1.0  # holes for the blur to fill
    for size in (21, 5):
        assert np.array_equal(native.blur_into_black_native(img, size),
                              jnative.blur_into_black_native(jimg, size))


@pytest.mark.parametrize("mode,seed", [("kubric", 0), ("kubric", 1), ("pardom", 0)])
def test_plain_splat_and_blur_match_jax(mode, seed):
    """The plain PyTorch splat and hole filling against the JAX package's
    jittable ones: the same per-pixel shift, summed in another order."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(3000, 3)).astype(np.float32) * (9.0 if mode == "pardom" else 1.5)
    xyz[:, 2] += 1.0
    rgb = rng.random((3000, 3)).astype(np.float32)
    valid = rng.random(3000) > 0.1
    k = np.array([[45.5, 0, 26], [0, 47.25, 18], [0, 0, 1]], np.float32)
    e = geometry.extrinsics_from_look_at([12.0, 3.0, 4.0], [0.0, 0.0, 1.0]).astype(np.float32)
    jimg, jw = jgeometry.splat_points_to_image(xyz, rgb, valid, k, e, 36, 52, mode=mode)
    img, w = geometry.splat_points_to_image(*map(torch.from_numpy, (xyz, rgb, valid, k, e)),
                                            36, 52, mode=mode)
    jimg, jw = np.asarray(jimg), np.asarray(jw)
    assert np.abs(img.numpy() - jimg).max() <= TOL
    assert np.abs(w.numpy() - jw).max() <= TOL * np.abs(jw).max()
    assert np.array_equal(img.numpy().sum(-1) == 0, jimg.sum(-1) == 0)
    for size, sigma in ((21, 21 / 4.0), (5, 1.5)):
        got = geometry.blur_into_black(img, size, sigma).numpy()
        want = np.asarray(jgeometry.blur_into_black(jimg, kernel_size=size, sigma=sigma))
        assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("src,dst", [((280, 420), (256, 384)), ((36, 52), (32, 48))])
def test_resize_is_cv2_s(src, dst):
    img = np.random.default_rng(0).random(src + (3,)).astype(np.float32)
    got = process_image(img, False, dst[1], dst[0])
    want = jprocess_image(img, False, dst[1], dst[0])
    assert got.shape == want.shape == dst + (3,) and got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("idx", [0, 3, 5])
def test_dataset_items_match_jax(root, idx):
    kwargs = _dataset_kwargs(root)
    _assert_same_items(KubricSynthViewDataset(**kwargs)[idx],
                       jkubric.KubricSynthViewDataset(**kwargs)[idx])


def test_dataset_next_example_override_matches_jax(root):
    kwargs = _dataset_kwargs(root)
    port, ref = KubricSynthViewDataset(**kwargs), jkubric.KubricSynthViewDataset(**kwargs)
    example = [0, 2, 1, True, 30.0, 75.0, 10.0, 20.0, 14.0, 16.0]
    port.set_next_example(*example)
    ref.set_next_example(*example)
    got, want = port[2], ref[2]
    _assert_same_items(got, want)
    assert list(got["clip_frames"]) == [5, 3, 1]


@pytest.mark.parametrize("idx", [0, 4])
def test_reproject_rgbd_items_match_jax(root, idx):
    """With reproject_rgbd, the baseline (view 0 of this 4-view root, a
    3-pixel hole fill) matches JAX's, has holes where one view sees
    nothing, and changes nothing else of the item: the train item bit for
    bit."""
    kwargs = _dataset_kwargs(root)
    port, ref = KubricSynthViewDataset(**kwargs), jkubric.KubricSynthViewDataset(**kwargs)
    port.reproject_rgbd = ref.reproject_rgbd = True
    got = port[idx]
    _assert_same_items(got, ref[idx])
    assert got["reproject"].shape == (3, 32, 48, 3) and got["reproject"].dtype == np.float32
    visible = ((got["reproject"] + 1.0) / 2.0).sum(-1) > 0.05
    assert 0.0 < visible.mean() < 1.0
    plain = KubricSynthViewDataset(**kwargs)[idx]
    assert sorted(got) == sorted([*plain, "reproject"])
    for k, v in plain.items():
        assert np.array_equal(got[k], v), k


def test_sample_trajectories_spherical_start_end_match_jax(root):
    """sample_trajectories with a given start and / or end pose draws the
    rest from rng as JAX's does. JAX's also returns the two poses: the port
    returns the trajectories, extrinsics and motion amount."""
    kwargs = _dataset_kwargs(root)
    port, ref = KubricSynthViewDataset(**kwargs), jkubric.KubricSynthViewDataset(**kwargs)
    start, end = [30.0, 10.0, 14.0], [75.0, 20.0, 16.0]
    for s, e in ((None, None), (start, None), (None, end), (start, end)):
        got = port.sample_trajectories(np.random.default_rng(3), s, e)
        want = ref.sample_trajectories(np.random.default_rng(3), s, e)
        assert len(got) == len(want) - 2
        for g, w in zip(got, want[2:]):
            assert np.array_equal(np.asarray(g), np.asarray(w))
        if s is not None:
            assert np.array_equal(got[0][0], np.float32(start))
        if e is not None:
            assert np.array_equal(got[1][-1], np.float32(end))


@pytest.fixture(scope="module")
def root2(tmp_path_factory):
    """Two scenes: scene 1 is the validation split of train_videos = 1,
    val_videos = 1."""
    path = str(tmp_path_factory.mktemp("kubric_port_val"))
    make_kubric_root(path, n_scenes=2)
    return path


def test_val_split_items_match_jax(root2):
    """The module's validation split (scenes [1, 2)): its items, and an
    eval example in set_next_example mode with the baseline, as the
    evaluation entry renders it."""
    params = dict(load_config(TINY_CONFIG)["data"]["params"],
                  dset_root=os.path.join(root2, "data"), pcl_root=os.path.join(root2, "pcl"),
                  val_videos=1)
    port, ref = KubricSynthViewModule(**params), jkubric.KubricSynthViewModule(**params)
    assert (port.val_dataset.start_idx, port.val_dataset.end_idx) == (1, 2)
    for idx in (0, 3):
        got = port.val_dataset[idx]
        _assert_same_items(got, ref.val_dataset[idx])
        assert int(got["scene_idx"][0]) == 1
    for d in (port.val_dataset, ref.val_dataset):
        d.reproject_rgbd = True
        d.set_next_example(1, 2, 1, False, 30.0, 75.0, 10.0, 20.0, 14.0, 16.0)
    got = port.val_dataset[0]
    _assert_same_items(got, ref.val_dataset[0])
    assert "reproject" in got and list(got["clip_frames"]) == [1, 3, 5]
    batches = list(port.val_dataloader())
    assert len(batches) == len(port.val_dataset) // port.batch_size


def test_loader_order_and_batches_match_jax(root):
    """Two epochs of the shuffled loader: the same items in the same
    batches, collated the same way."""
    kwargs = _dataset_kwargs(root)
    port = PrefetchLoader(KubricSynthViewDataset(**kwargs), 2, num_workers=2)
    ref = JPrefetchLoader(jkubric.KubricSynthViewDataset(**kwargs), 2, num_workers=2)
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            _assert_same_items(g, w)
    assert got[0]["jpg"].shape == (6, 32, 48, 3) and got[0]["num_video_frames"] == 3


def test_loader_stops_its_workers_when_the_consumer_stops(root):
    """A consumer that leaves an epoch early (training stops at max_steps)
    leaves no worker thread behind."""
    before = set(threading.enumerate())
    it = iter(PrefetchLoader(KubricSynthViewDataset(**_dataset_kwargs(root)), 2, num_workers=2))
    next(it)
    next(it)
    assert set(threading.enumerate()) - before
    it.close()
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]


def test_batch_to_device_keeps_python_values():
    batch = collate_fn([{"jpg": np.ones((3, 2, 2, 3), np.float32),
                         "fps_id": np.full((3,), 6, np.int32),
                         "image_only_indicator": np.zeros((1, 3), np.float32)}] * 2)
    out = batch_to_device(batch, "cpu")
    assert out["num_video_frames"] == 3 and isinstance(out["num_video_frames"], int)
    assert out["jpg"].shape == (6, 2, 2, 3) and out["jpg"].dtype == torch.float32
    assert out["fps_id"].dtype == torch.int32 and out["image_only_indicator"].shape == (2, 3)
    assert np.array_equal(out["fps_id"].numpy(), batch["fps_id"])


def test_render_point_cloud_raises_when_the_splat_cannot_be_built(monkeypatch, tmp_path):
    """No compiler: the renderer raises; nothing renders in its place."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    xyz = np.zeros((4, 3), np.float32)
    k = np.eye(3, dtype=np.float32)
    with pytest.raises(RuntimeError, match="cannot build the native splat"):
        geometry.render_point_cloud(xyz, xyz, k, np.eye(4, dtype=np.float32), 8, 8)

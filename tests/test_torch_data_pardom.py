"""The port's ParallelDomain-4D data pipeline on the CPU against the JAX
package: the synthetic root, the PD camera matrices and spherical math, the
frame loaders and visualisations, the dataset's items in every camera mode,
the loader's order and batches, the data module through the config, and the
training entry on configs/smoke_pardom_tiny.yaml.

The root is the tiny one of scripts/make_fake_data.py (19 views of 1,500
points a frame, 64x48 ego frames), here with the 16 surround cameras'
frames too. Both datasets render with their native splat, built from the
same source with the same flags, so the images agree bit for bit before the
resize; the port resizes with PyTorch's bilinear interpolation where the
JAX package calls cv2.resize, which differ in the order of fp32 sums (~1e-7
here): floats are held to 1e-5 absolute, as the Kubric pipeline's.
"""

import copy
import csv
import os
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu import native as jnative
from gcd_tpu.data import common as jcommon
from gcd_tpu.data import geometry as jgeometry
from gcd_tpu.data import pardom as jpardom
from gcd_tpu.data.loader import PrefetchLoader as JPrefetchLoader
from gcd_tpu.utils.config import instantiate_from_config as j_instantiate
from gcd_tpu_torch import train
from gcd_tpu_torch.data import common, geometry
from gcd_tpu_torch.data.fake import (class_ontology_items, make_pardom_root,
                                     pardom_ontology_items)
from gcd_tpu_torch.data.loader import PrefetchLoader
from gcd_tpu_torch.data.pardom import ParallelDomainSynthViewDataset, ParallelDomainSynthViewModule
from gcd_tpu_torch.data.png import read_png, write_png
from gcd_tpu_torch.diffusion.loss import PERSON_RGB, VEHICLE_RGB
from gcd_tpu_torch.engine.trainer import Trainer, load_trainer
from gcd_tpu_torch.utils.config import apply_dotlist, instantiate_from_config, load_config
from scripts import make_fake_data
from tests.torch_port_helpers import engine_params, engine_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PD_TINY = os.path.join(REPO, "configs", "smoke_pardom_tiny.yaml")
TOL = 1e-5
TCM = 3


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
    path = str(tmp_path_factory.mktemp("pardom_port"))
    make_pardom_root(path, magic_frames=True)
    return path


def _kwargs(root, **over):
    kwargs = dict(dset_root=os.path.join(root, "data"), split="train", start_idx=0, end_idx=1,
                  pcl_root=os.path.join(root, "pcl"), model_frames=TCM, input_frames=TCM,
                  output_frames=TCM, frame_width=96, frame_height=64, render_width=104,
                  render_height=72, move_time=2, mock_dset_size=4, trajectory="interpol_sine")
    kwargs.update(over)
    return kwargs


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


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_fake_root_is_make_fake_data_s(tmp_path):
    """The same files, pixels, tensors and JSON as scripts/make_fake_data.py
    for the same seed (its PNGs are cv2's, the port's its own writer's)."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    make_pardom_root(port)
    make_fake_data.make_pardom_root(ref)
    files = _files(port)
    assert files == _files(ref) and len(files) == 50 * 2 + 3
    for f in files:
        a, b = os.path.join(port, f), os.path.join(ref, f)
        if f.endswith(".json"):
            assert open(a).read() == open(b).read()
        elif f.endswith(".png"):
            assert np.array_equal(read_png(a), cv2.imread(b, cv2.IMREAD_UNCHANGED)[..., ::-1])
        else:
            for x, y in zip(torch.load(a, weights_only=True), torch.load(b, weights_only=True)):
                assert x.dtype == y.dtype and torch.equal(x, y)


def test_fake_root_options(tmp_path):
    """Frame size, points a view, the surround cameras' frames, the
    ontology and class ids by cell."""
    items = pardom_ontology_items()[:4]
    items[2] = {"id": 2, "color": {"r": 220, "g": 20, "b": 60}}
    make_pardom_root(str(tmp_path), n_frames=2, n_points=40, frame_hw=(10, 14),
                     magic_frames=True, ontology_items=items, segm_cell=2.0)
    scene = tmp_path / "data" / "scene_000000"
    assert read_png(str(scene / "rgb" / "camera15" / f"{15:018d}.png")).shape == (10, 14, 3)
    assert read_png(str(scene / "rgb" / "yaw-0" / f"{5:018d}.png")).shape == (10, 14, 3)
    assert jcommon.load_json(str(scene / "ontology" / "onto.json"))["items"] == items
    xyz, _, segm, _ = torch.load(str(tmp_path / "pcl" / "scene_000000" /
                                     "pcl_rgb_segm_000005.pt"), weights_only=True)
    assert xyz.shape == (19, 40, 3) and segm.shape == (19, 40, 1)
    cell = np.floor(xyz[..., :2].float().numpy() / 2.0).astype(np.int64)
    assert np.array_equal(segm[..., 0].numpy(), (cell[..., 0] + 3 * cell[..., 1]) % 4)


@pytest.mark.parametrize("calibration", ["fake", "orientation"])
def test_pardom_camera_matrices_match_jax(root, calibration):
    calib = jcommon.load_json(os.path.join(root, "data", "scene_000000", "calibration",
                                           "calib.json"))
    if calibration == "orientation":  # the other key names, and a lidar to drop
        calib = copy.deepcopy(calib)
        for i, e in enumerate(calib["extrinsics"]):
            q = np.random.default_rng(i).normal(size=4)
            e["orientation"] = dict(zip("wxyz", q.tolist()))
            e["position"] = e.pop("translation")
            del e["rotation"]
        calib["names"].append("velodyne")
        calib["intrinsics"].append(calib["intrinsics"][0])
        calib["extrinsics"].append(calib["extrinsics"][0])
    names, k, e = geometry.get_pardom_camera_matrices(calib)
    jnames, jk, je = jgeometry.get_pardom_camera_matrices(calib)
    assert names == jnames and len(names) == 19 and names[-3:] == ["yaw-0", "yaw-60",
                                                                    "yaw-neg-60"]
    assert k.dtype == jk.dtype and np.array_equal(k, jk)
    assert e.dtype == je.dtype and np.array_equal(e, je)


def test_spherical_math_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(64, 3)) * 10
    for deg in (False, True):
        assert np.array_equal(geometry.spherical_from_cartesian(pts, rad2deg=deg),
                              jgeometry.spherical_from_cartesian(pts, rad2deg=deg))
    # Across the azimuth wrap both ways, and a plain move.
    pairs = [([-10.0, 0.5, 6.0], [-10.0, -0.5, 8.0]), ([-10.0, -0.5, 6.0], [-10.0, 0.5, 8.0]),
             ([12.0, 3.0, 4.0], [-3.0, 14.0, 9.0])]
    for start, end in pairs:
        for alpha in (0.0, 0.3, 1.0):
            got = geometry.interpolate_spherical(start, end, alpha)
            assert np.array_equal(got, jgeometry.interpolate_spherical(start, end, alpha))
    mid = geometry.interpolate_spherical(*pairs[0], 0.5)
    assert mid[0] < -9.0  # the short way round, behind the origin


CASES = {
    "ego_forward-topdown1": {},
    "segm": dict(output_modality="segm"),
    "modal_time": dict(output_modality="segm", modal_time=2),
    "topdown2": dict(output_mode="topdown2", dst_azimuth_range=[-60.0, 60.0]),
    "magic": dict(input_mode="magic_random", output_mode="magic_opposite", move_time=0),
    "traffic1": dict(input_mode="traffic1", output_mode="traffic1",
                     dst_azimuth_range=[-90.0, 90.0]),
    "linear-shuffled": dict(trajectory="interpol_linear", force_shuffle=True, reverse_prob=0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("idx", [0, 3])
def test_dataset_items_match_jax(root, case, idx):
    kwargs = _kwargs(root, **CASES[case])
    got = ParallelDomainSynthViewDataset(**kwargs)[idx]
    _assert_same_items(got, jpardom.ParallelDomainSynthViewDataset(**kwargs)[idx])
    assert got["jpg"].shape == (TCM, 64, 96, 3) and np.abs(got["jpg"]).max() > 0.05
    if case == "magic":
        assert got["dst_view_idx"][0] == (got["src_view_idx"][0] + 8) % 16


def test_reproject_rgbd_matches_jax(root):
    port = ParallelDomainSynthViewDataset(**_kwargs(root))
    ref = jpardom.ParallelDomainSynthViewDataset(**_kwargs(root))
    port.reproject_rgbd = ref.reproject_rgbd = True
    got = port[1]
    _assert_same_items(got, ref[1])
    assert got["reproject"].shape == (TCM, 64, 96, 3)


@pytest.mark.parametrize("example", [[0, "scene_000000", 2, 3, True], [-1, "unused", 1, 0, False]])
def test_next_example_override_matches_jax(root, example):
    port = ParallelDomainSynthViewDataset(**_kwargs(root))
    ref = jpardom.ParallelDomainSynthViewDataset(**_kwargs(root))
    port.set_next_example(*example)
    ref.set_next_example(*example)
    got = port[2]
    _assert_same_items(got, ref[2])
    if example[0] >= 0:
        assert list(got["clip_frames"]) == [7, 5, 3]
    else:  # a camera-only item
        assert "jpg" not in got and got["scaled_relative_pose"].shape == (TCM, 3, 4)


def test_split_json_absolute_and_relative(root, monkeypatch):
    """The split file's lists; a relative path is read from the working
    directory, as the reference's is."""
    split = os.path.join(root, "data", "pardom_datasplit.json")
    ds = ParallelDomainSynthViewDataset(**_kwargs(root, split_json=split, split="val"))
    assert ds.all_scene_dns == ["scene_000000"] and ds.num_scenes == 1
    monkeypatch.chdir(os.path.join(root, "data"))
    ds = ParallelDomainSynthViewDataset(**_kwargs(root, split_json="pardom_datasplit.json"))
    assert ds.all_scene_dns == ["scene_000000"]
    _assert_same_items(ds[0], ParallelDomainSynthViewDataset(**_kwargs(root))[0])


def test_bad_camera_modes_raise_at_construction(root):
    with pytest.raises(ValueError, match="magic_opposite takes input_mode magic_random"):
        ParallelDomainSynthViewDataset(**_kwargs(root, output_mode="magic_opposite"))
    with pytest.raises(ValueError, match="expected one of"):
        ParallelDomainSynthViewDataset(**_kwargs(root, input_mode="ego_left"))
    with pytest.raises(ValueError, match="topdown1 takes dst_azimuth_range"):
        ParallelDomainSynthViewDataset(**_kwargs(root, dst_azimuth_range=[-5.0, 5.0]))


def test_loader_order_and_batches_match_jax(root):
    """Two epochs of the shuffled loader: the same items in the same
    batches, collated the same way."""
    kwargs = _kwargs(root)
    port = PrefetchLoader(ParallelDomainSynthViewDataset(**kwargs), 2, num_workers=2)
    ref = JPrefetchLoader(jpardom.ParallelDomainSynthViewDataset(**kwargs), 2, num_workers=2)
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _assert_same_items(g, w)
    assert got[0]["jpg"].shape == (2 * TCM, 64, 96, 3) and got[0]["num_video_frames"] == TCM


def test_module_resolves_through_the_config(root):
    """configs/smoke_pardom_tiny.yaml's data section builds the port's
    module by its reference name, with both splits and their loaders."""
    data = apply_dotlist(load_config(PD_TINY), [
        f"data.params.dset_root={root}/data", f"data.params.pcl_root={root}/pcl"])["data"]
    assert data["target"] == "sgm.data.pardom_arbit.ParallelDomainSynthViewModule"
    module = instantiate_from_config(data)
    assert isinstance(module, ParallelDomainSynthViewModule)
    assert module.train_dataset.split == "train" and module.val_dataset.split == "val"
    assert module.train_dataset.avail_frames == 50
    loader = module.train_dataloader()
    assert isinstance(loader, PrefetchLoader) and isinstance(module.val_dataloader(),
                                                             PrefetchLoader)
    batch = next(iter(loader))
    assert batch["jpg"].shape == (2 * 3, 32, 48, 3) and np.isfinite(batch["jpg"]).all()


def _ontology(root):
    return ParallelDomainSynthViewDataset(**_kwargs(root)).ontology


def test_frame_visualisations_match_jax(root, tmp_path):
    """segm (packed ids through the ontology), motion (HSV colours) and
    surface frames of a surround camera, as the JAX package reads them, and
    a depth frame's plasma colours as JAX's visualize_pardom_frame makes
    them (instance raises)."""
    scene = str(tmp_path / "scene_000000")
    rng = np.random.default_rng(3)
    for t in (4, 6):
        name = f"{t * 10 + 5:018d}.png"
        ids = rng.integers(0, 30, (24, 40))
        semantic = np.stack([ids, np.zeros_like(ids), np.zeros_like(ids)], -1).astype(np.uint8)
        for modality, img in (("semantic_segmentation_2d", semantic),
                              ("motion_vectors_2d", rng.integers(0, 256, (24, 40, 4), np.uint8)),
                              ("surface_normals_2d", rng.integers(0, 256, (24, 40, 3), np.uint8))):
            os.makedirs(os.path.join(scene, modality, "camera5"), exist_ok=True)
            write_png(os.path.join(scene, modality, "camera5", name), img, filters=t % 5)
    ontology = _ontology(root)
    for modality in ("segm", "motion_vectors_2d", "surface_normals_2d"):
        got = common.load_pardom_video_vis_frames(scene, modality, "magic", 5, ontology,
                                                  [4, 6], True, 48, 32)
        want = jcommon.load_pardom_video_vis_frames(scene, modality, "magic", 5, ontology,
                                                    [4, 6], True, 48, 32)
        assert got.shape == want.shape == (2, 32, 48, 3)
        assert np.abs(got - want).max() <= TOL, modality
    raw = common.load_pardom_frame(scene, "semantic_segmentation_2d", "camera5", 4)
    assert np.array_equal(raw, jcommon.load_pardom_frame(scene, "semantic_segmentation_2d",
                                                         "camera5", 4))
    depth = rng.uniform(0.5, 80.0, (24, 40)).astype(np.float32)
    got = common.visualize_pardom_frame(depth, "depth", "camera5", ontology)
    want = jcommon.visualize_pardom_frame(depth, "depth", "camera5", ontology)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(NotImplementedError, match="no ontology"):
        common.visualize_pardom_frame(raw, "instance_segmentation_2d", "camera5", ontology)


def test_hsv_to_rgb_is_matplotlib_s():
    import matplotlib.colors  # the test host has it; the card's machine need not

    rng = np.random.default_rng(0)
    hsv = rng.random((50, 3)).astype(np.float32)
    hsv[:5, 0] = [0.0, 1.0 / 6, 0.5, 5.0 / 6, 1.0]  # sector edges, hue 1 wraps to 0
    hsv[5:8, 1] = 0.0  # gray
    for x in (hsv, hsv.astype(np.float64)):
        got, want = common.hsv_to_rgb(x), matplotlib.colors.hsv_to_rgb(x)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_entry_trains_the_tiny_pardom_config_on_the_cpu(root, tmp_path):
    """python -m gcd_tpu_torch.train --device cpu -b configs/smoke_pardom_tiny.yaml:
    two steps from a synthetic root, finite losses, the CSV's rows and the
    end-of-run checkpoint; load_trainer on the config trains the same
    parameters at the same rate."""
    stats = train.main(["--device", "cpu", "-b", PD_TINY, "-l", str(tmp_path),
                        f"data.params.dset_root={root}/data",
                        f"data.params.pcl_root={root}/pcl", "--max_steps", "2"])
    assert stats["steps"] == [1, 2] and all(np.isfinite(stats["losses"]))
    with open(os.path.join(stats["logdir"], "metrics.csv"), newline="") as f:
        assert [int(r["step"]) for r in csv.DictReader(f)] == [1, 2]
    assert os.listdir(os.path.join(stats["logdir"], "checkpoints")) == ["step_2"]
    engine = stats["trainer"].engine
    assert type(engine.conditioner.embedders[-1]).__name__ == "SphericalEmbedder"
    trainer = load_trainer(PD_TINY, device="cpu", dtype=torch.float32)
    assert trainer.trainable_names == stats["trainer"].trainable_names
    assert trainer.optimizer.defaults["lr"] == stats["trainer"].optimizer.defaults["lr"]


MODEL_KEYS = ("jpg", "cond_frames", "cond_frames_without_noise", "cond_aug", "fps_id",
              "motion_bucket_id", "scaled_relative_angles", "image_only_indicator")


def _class_root(path):
    """The tiny root with ids 1-14 in the loss's person and vehicle colours
    and class ids by 3 m cell, so that a semantic target holds whole
    regions of class colour."""
    make_pardom_root(path, ontology_items=class_ontology_items(), segm_cell=3.0)


def _class_share(jpg) -> float:
    """The share of target pixels within the loss's 0.02 of a class colour."""
    ref = np.asarray(PERSON_RGB + VEHICLE_RGB, np.float32) / 127.5 - 1.0
    near = np.abs(jpg[..., None, :] - ref).mean(-1) < 0.02
    return float(near.any(-1).mean())


def test_pd_weighted_loss_matches_jax(tmp_path):
    """One train_step's loss on configs/smoke_pardom_tiny.yaml with
    pd_person_weight 7 and pd_vehicle_weight 3, on a PD batch whose semantic
    targets hold class-coloured pixels, against the loss the JAX trainer's
    train_step differentiates (engine.loss(...).mean()): the same weights,
    and the port given JAX's draws (posterior noise, sigma, noise) from the
    step's key, as tests/test_torch_train_step.py does. ucg_rate 0 (flax's
    dropout draws cannot be handed across); fp32, JAX at highest matmul
    precision: held to 1e-5 relative."""
    root = str(tmp_path / "pd")
    _class_root(root)
    cfg = apply_dotlist(load_config(PD_TINY), [
        f"data.params.dset_root={root}/data", f"data.params.pcl_root={root}/pcl"])
    batch_np = next(iter(instantiate_from_config(cfg["data"]).train_dataloader()))
    batch = {k: batch_np[k] for k in MODEL_KEYS}
    bt, h, w, _ = batch["jpg"].shape
    assert _class_share(batch["jpg"]) > 0.0

    model = cfg["model"]
    model["params"]["en_and_decode_n_samples_a_time"] = bt  # one chunk
    model["params"]["loss_fn_config"]["params"].update(pd_person_weight=7.0,
                                                       pd_vehicle_weight=3.0)
    emb_models = model["params"]["conditioner_config"]["params"]["emb_models"]
    for emb in emb_models:
        emb.pop("ucg_rate", None)
    jeng = j_instantiate(copy.deepcopy(model))
    params = engine_params(jeng, batch, 80)
    engine = instantiate_from_config(copy.deepcopy(model))
    engine.load_state_dict(engine_state_dict(params, emb_models, 81), strict=True)

    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = float(jax.jit(lambda p, b, k: jeng.loss(p, b, k, 0).mean())(params, jbatch, key))
    k_enc, _, k_loss = jax.random.split(key, 3)
    k_sigma, k_noise, _ = jax.random.split(k_loss, 3)
    draws = {"posterior": jax.random.normal(jax.random.fold_in(k_enc, 0), (bt, h // 8, w // 8, 4)),
             "sigma_rand": jax.random.normal(k_sigma, (bt,)),
             "noise": jax.random.normal(k_noise, (bt, h // 8, w // 8, 4))}
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    trainer = Trainer(engine.eval(), float(model["base_learning_rate"]))
    got = float(trainer.train_step(tbatch, draws=draws)["loss"])
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)

    # The class term is there to match: without it the loss is another.
    engine.loss_fn.pd_person_weight = engine.loss_fn.pd_vehicle_weight = 1.0
    with torch.no_grad():
        plain = float(engine.loss(tbatch, 1, None, draws).mean())
    assert abs(plain - got) > 1e-3 * abs(got)

"""The fsdp and tensor axes of the port's mesh (gcd_tpu_torch/parallel/
mesh.py, engine/trainer.py, parallel/tensor.py) on the CPU.

* The placement rules against the JAX package's `make_param_shardings` on
  the flagship's and the tiny engine's UNet shapes (`jax.eval_shape`, no
  memory), at (fsdp, tensor) in {(2, 1), (4, 1), (2, 2), (1, 4)}: every
  parameter's fsdp and tensor dimensions equal JAX's, mapped through
  io/convert.py's layout, except the parameters the port places otherwise
  by design, each named with its reason (`_departures`); plus
  tests/test_parallel.py's rule cases.
* Runs of `python -m gcd_tpu_torch.train --device cpu` in gloo process
  groups (one PyTorch intra-op thread each) against the one-process run of
  the same seed, on configs/smoke_kubric_tiny.yaml with two accumulated
  micro-steps and EMA: two processes at fsdp 2, four at fsdp 2 x tensor 2,
  and, with time_lora, two at tensor 2. The tiny engine has no leaf of
  JAX's min_weight_size (2**18 elements), so the processes lower it to
  2**12 before they build, as tests/test_parallel.py:172 passes
  min_weight_size=2**12; each run's placement summary shows parameters
  sharded and cut. The losses equal the one-process run's to 1e-6 relative
  and the grad norms to 1e-5 (the data-parallel test's bounds: the same
  fp32 sums in another order); the trainer state at the last step,
  gathered whole, the masters, module weights and EMA to 1e-5 relative L2
  (1e-8 measured) and Adam's moments, sums of gradients whose small
  entries cancel, to 1e-4, the data-parallel test's bound on the
  accumulated gradient (1.6e-5 measured under time_lora at tensor 2).
* Checkpoints across meshes: the fsdp 2 x tensor 2 run's step_3 (in the
  middle of an accumulation) resumes in one process, and the one-process
  run's step_3 at fsdp 2, each to the continuous run's step 4 (a dataset of
  one batch, unshuffled, so a resumed epoch is the same batch).
"""

import json
import os
import re
import shutil
import subprocess
import sys
from collections.abc import Mapping

import numpy as np
import pytest
import torch

from gcd_tpu_torch import train
from gcd_tpu_torch.data.fake import make_kubric_root
from gcd_tpu_torch.io.checkpoint import restore_checkpoint
from gcd_tpu_torch.io.convert import _iter_tree_paths, flax_path_to_torch_key, \
    torch_layout_from_flax
from gcd_tpu_torch.parallel import distributed
from gcd_tpu_torch.parallel.mesh import (Placement, join_blocks, param_placement, shard_blocks,
                                         unet_placements)
from gcd_tpu_torch.utils.config import instantiate_from_config, load_config
from tests.torch_port_helpers import REPO, TINY_CONFIG
from tests.test_torch_distributed import _free_port, _rows

FLAGSHIP = os.path.join(REPO, "configs", "train_kubric_max90.yaml")
MESHES = [(2, 1), (4, 1), (2, 2), (1, 4)]
MIN_WEIGHT = 2 ** 12
STEPS, CKPT_STEP = 4, 3
OPTIONS = ["model.params.use_ema=true", "lightning.trainer.accumulate_grad_batches=2",
           f"lightning.modelcheckpoint.params.every_n_train_steps={CKPT_STEP}",
           "lightning.callbacks.image_logger.params.batch_frequency=2",
           "data.params.mock_dset_size=2", "data.params.shuffle=false"]
LORA = ["model.params.ft_strategy=time_lora"]
# The entry with JAX's min_weight_size lowered before anything is built.
ENTRY = ("import sys; import gcd_tpu_torch.parallel.mesh as m; m.MIN_WEIGHT_SIZE = "
         f"{MIN_WEIGHT}; from gcd_tpu_torch import train; train.main(sys.argv[1:])")


# ---- the placement rules against JAX ----------------------------------------


def _torch_dims(kind: str, ndim: int):
    """{flax dim: torch dim} of io/convert.py's layout for a leaf kind."""
    sizes = (2, 3, 5, 7, 11)[:ndim]
    torch_shape = torch_layout_from_flax(np.empty(sizes), kind).shape
    return {i: torch_shape.index(s) for i, s in enumerate(sizes)}


def _jax_placements(params, fsdp, tensor):
    from gcd_tpu.parallel.mesh import create_mesh, make_param_shardings
    import jax

    mesh = create_mesh(data=1, fsdp=fsdp, tensor=tensor,
                       devices=jax.devices()[:fsdp * tensor])
    shardings = dict(_iter_tree_paths(make_param_shardings(params, mesh, MIN_WEIGHT)))
    out = {}
    for path, leaf in _iter_tree_paths(params):
        sh = shardings[path]
        key, kind = flax_path_to_torch_key(path)
        dims = _torch_dims(kind, len(leaf.shape))
        axes = {a: dims[i] for i, a in enumerate(sh.spec) if a is not None}
        out[key] = (axes.get("fsdp"), axes.get("tensor"))
    return out


def _shape_tree(tree):
    return {k: _shape_tree(v) if isinstance(v, Mapping) else v for k, v in tree.items()}


@pytest.fixture(scope="module", params=["flagship", "tiny"])
def unets(request):
    """(JAX's UNet param shapes as a nested dict, the port's UNet on meta)."""
    import jax
    import jax.numpy as jnp
    from gcd_tpu.utils.config import instantiate_from_config as j_instantiate

    path = FLAGSHIP if request.param == "flagship" else TINY_CONFIG
    cfg = load_config(path)["model"]["params"]["network_config"]
    net = j_instantiate(cfg)
    bt, t, z = 2, 2, jnp.zeros
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.PRNGKey(0), z((bt, 8, 8, net.in_channels)), z((bt,)),
        z((bt, 1, net.context_dim)), z((bt, net.adm_in_channels + net.aux_emb_dim)),
        num_video_frames=t, image_only_indicator=z((bt // t, t))))["params"]
    with torch.device("meta"):
        unet = instantiate_from_config(cfg)
    return _shape_tree(shapes), unet


def _departures(unet, keys, tensor):
    """{key: reason} of the parameters the port places otherwise than JAX."""
    heads = {n: m.heads for n, m in unet.named_modules() if hasattr(m, "to_q")}
    inner = {n: m.net[2].in_features for n, m in unet.named_modules() if hasattr(m, "net")}
    out = {}
    for key in keys:
        module = key.rsplit(".", 1)[0]
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            owner = module[:-len(proj) - 1]
            if module.endswith("." + proj) and heads[owner] % tensor and key.endswith("weight"):
                out[key] = f"{heads[owner]} heads do not divide by {tensor}: left uncut"
        if module.endswith(".net.0.proj") and inner[module[:-len(".net.0.proj")]] % (
                tensor * 64) == 0:
            out[key] = "K3's [value_r | gate_r] rows cut (JAX leaves the fused projection)"
        if module.endswith(".net.2") and key.endswith("weight") and inner[
                module[:-len(".net.2")]] % (tensor * 64):
            out[key] = "inner size not a multiple of tensor x INNER_TILE: left uncut"
    return out


@pytest.mark.parametrize("fsdp,tensor", MESHES)
def test_placement_matches_jax(unets, fsdp, tensor):
    params, unet = unets
    want = _jax_placements(params, fsdp, tensor)
    got = unet_placements(unet, fsdp, tensor, MIN_WEIGHT)
    assert set(got) == set(want)
    differ = {k for k in got if (got[k].fsdp_dim, got[k].tensor_dim) != want[k]}
    expected = _departures(unet, got, tensor) if tensor > 1 else {}
    assert differ == set(expected), sorted(differ ^ set(expected))[:8]
    for k in differ:  # the port's own rule there: no cut where JAX cuts, or K3's cut
        assert (got[k].tensor_dim is None) != (want[k][1] is None), k
    assert any(p.fsdp_dim is not None for p in got.values()) == (fsdp > 1)
    if tensor > 1:
        assert any(p.tensor_dim is not None for p in got.values())


def test_placement_rule_cases():
    """tests/test_parallel.py:42-75 on the port's rule: big, small, odd,
    and the excluded embedding MLPs."""
    assert param_placement("big.weight", (512, 1024), 4, 1, 1024) == Placement(fsdp_dim=1)
    assert param_placement("small.bias", (32,), 4, 1, 1024) == Placement()
    assert param_placement("odd.weight", (7, 1023), 4, 1, 1024) == Placement()
    for name in ("time_embed.0.weight", "aux_label_emb.0.weight",
                 "input_blocks.1.0.emb_layers.1.weight"):
        assert param_placement(name, (512, 1024), 4, 1, 1024) == Placement(), name
    conv = param_placement("input_blocks.1.0.in_layers.2.weight", (512, 1024, 3, 3), 4, 1, 1024)
    assert conv == Placement(fsdp_dim=1)  # HWIO's I (1024), the largest
    square = param_placement("input_blocks.1.0.in_layers.2.weight", (512, 512, 3, 3), 4, 1, 1)
    assert square == Placement(fsdp_dim=1)  # HWIO: I comes before O, the first largest
    attn = "b.attn1.to_q.weight"
    assert param_placement(attn, (64, 64), 2, 2, 2 ** 30, heads=4) == Placement(tensor_dim=0)
    assert param_placement(attn, (64, 64), 2, 2, 1, heads=4) == Placement(1, 0)
    assert param_placement(attn, (64, 64), 2, 2, 1, heads=5) == Placement(fsdp_dim=1)
    assert param_placement("b.attn1.to_out.0.bias", (64,), 1, 2, 1, heads=4) == Placement()
    up = param_placement("b.ff.net.0.proj.weight", (512, 64), 1, 2, 1)
    assert up == Placement(tensor_dim=0, tensor_blocks=2)
    w = torch.arange(8.0).reshape(8, 1)  # [v0 v1 v2 v3 | g0 g1 g2 g3]
    shares = [shard_blocks(w, 0, 2, r, 2) for r in range(2)]
    assert shares[1].flatten().tolist() == [2.0, 3.0, 6.0, 7.0]
    assert torch.equal(join_blocks(shares, 0, 2), w)


# ---- runs of the entry in gloo process groups --------------------------------


def _args(root, logdir, name, *extra):
    return ["--device", "cpu", "-b", TINY_CONFIG, "-l", logdir, "-n", name, "--no_date",
            f"data.params.dset_root={root}/data", f"data.params.pcl_root={root}/pcl",
            "--max_steps", str(STEPS), *OPTIONS, *extra]


def _launch(args, nproc, *mesh):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONSTARTUP", None)
    return [subprocess.Popen(
        [sys.executable, "-c", ENTRY, *args, "--coordinator", f"127.0.0.1:{port}",
         "--num_processes", str(nproc), "--process_id", str(pid), *mesh],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nproc)]


def _wait(procs):
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            proc.kill()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-4000:]
    return outs


def _one(args):
    """The entry in this process, on one PyTorch thread (no mesh)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return train.main(args)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The mesh runs (started first, they run beside the one-process runs
    in this process), then the resumes across meshes."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    root = os.path.join(tmp, "kubric")
    make_kubric_root(root)
    procs = {"f2t2": _launch(_args(root, tmp, "f2t2"), 4, "--mesh_fsdp", "2",
                             "--mesh_tensor", "2"),
             "t2": _launch(_args(root, tmp, "t2", *LORA), 2, "--mesh_tensor", "2"),
             "f2": _launch(_args(root, tmp, "f2"), 2, "--mesh_fsdp", "2")}
    quiet = "lightning.callbacks.image_logger.params.disabled=true"
    one = _one(_args(root, tmp, "one", quiet))
    one_lora = _one(_args(root, tmp, "one_lora", *LORA, quiet))
    outs = {name: _wait(p) for name, p in procs.items()}
    # Resumes from step_3: the fsdp 2 x tensor 2 checkpoint in one process,
    # the one-process checkpoint at fsdp 2.
    for src, dst in (("f2t2", "f2t2_in_one"), ("one", "one_at_f2")):
        shutil.copytree(os.path.join(tmp, src), os.path.join(tmp, dst))
        for step in os.listdir(os.path.join(tmp, dst, "checkpoints")):
            if step != f"step_{CKPT_STEP}":
                shutil.rmtree(os.path.join(tmp, dst, "checkpoints", step))
        with open(os.path.join(tmp, dst, "metrics.csv")) as f:
            head = f.readlines()[:CKPT_STEP + 1]
        with open(os.path.join(tmp, dst, "metrics.csv"), "w") as f:
            f.writelines(head)
    resume = ["--device", "cpu", "--max_steps", str(STEPS), "--resume"]
    at_f2 = _launch([*resume, os.path.join(tmp, "one_at_f2")], 2, "--mesh_fsdp", "2")
    in_one = _one([*resume, os.path.join(tmp, "f2t2_in_one")])
    outs["one_at_f2"] = _wait(at_f2)
    return dict(tmp=tmp, one=one, one_lora=one_lora, in_one=in_one, outs=outs)


def _summary(out):
    return json.loads(re.search(r"^Placement: (.*)$", out, re.M).group(1))


def _close(rows, want):
    loss = np.array([float(r["loss"]) for r in rows])
    norm = np.array([float(r["grad_norm"]) for r in rows])
    np.testing.assert_allclose(loss, [float(r["loss"]) for r in want], rtol=1e-6, atol=0)
    np.testing.assert_allclose(norm, [float(r["grad_norm"]) for r in want], rtol=1e-5, atol=0)


def _flat(state, prefix=""):
    """Every tensor of a trainer checkpoint, flattened, by path."""
    if isinstance(state, dict):
        return {k2: v2 for k, v in state.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: state} if isinstance(state, torch.Tensor) else {}


def _same_state(tmp, a, b, step):
    sa = _flat(restore_checkpoint(os.path.join(tmp, a, "checkpoints"), step))
    sb = _flat(restore_checkpoint(os.path.join(tmp, b, "checkpoints"), step))
    assert sorted(sa) == sorted(sb)
    for group, tol in (("/masters/", 1e-5), ("/module/model_ema", 1e-5),
                       ("/module/model.", 1e-5), ("/optimizer/", 1e-4)):
        keys = [k for k in sa if k.startswith(group) and sa[k].dim()]
        assert keys, group
        x = torch.cat([sa[k].double().flatten() for k in keys])
        y = torch.cat([sb[k].double().flatten() for k in keys])
        assert all(sa[k].shape == sb[k].shape and sa[k].dtype == sb[k].dtype for k in keys)
        assert float((x - y).norm()) <= tol * float(x.norm()), group


@pytest.mark.parametrize("name,nproc,mesh", [("f2", 2, (2, 1)), ("f2t2", 4, (2, 2))])
def test_mesh_runs_take_the_one_process_steps(runs, name, nproc, mesh):
    tmp, outs = runs["tmp"], runs["outs"][name]
    want = _rows(os.path.join(tmp, "one"))
    rows = _rows(os.path.join(tmp, name))
    assert [int(r["step"]) for r in rows] == list(range(1, STEPS + 1))
    _close(rows, want)
    assert runs["one"]["trainer"].ema.num_updates == STEPS
    summary = _summary(outs[0])
    assert summary["mesh"] == {"fsdp": mesh[0], "tensor": mesh[1]}
    assert summary["fsdp"]["tensors"] + summary["both"]["tensors"] > 0
    assert (summary["tensor"]["tensors"] + summary["both"]["tensors"] > 0) == (mesh[1] > 1)
    assert f"Mesh: {{'data': 1, 'fsdp': {mesh[0]}, 'tensor': {mesh[1]}}}" in outs[0]
    assert all("Training finished" not in out for out in outs[1:])
    _same_state(tmp, "one", name, STEPS)
    logs = sorted(os.listdir(os.path.join(tmp, name, "images", "train")))
    assert [n.split("_")[0] for n in logs if n.endswith(".npz")] == ["gs-0000002",
                                                                     "gs-0000004"]


def test_time_lora_at_tensor_two(runs):
    tmp = runs["tmp"]
    _close(_rows(os.path.join(tmp, "t2")), _rows(os.path.join(tmp, "one_lora")))
    summary = _summary(runs["outs"]["t2"][0])
    assert summary["tensor"]["tensors"] > 0 and summary["mesh"]["tensor"] == 2
    _same_state(tmp, "one_lora", "t2", STEPS)
    sd = restore_checkpoint(os.path.join(tmp, "t2", "checkpoints"), STEPS)["module"]
    assert any(k.endswith("lora_b") and float(v.abs().max()) > 0 for k, v in sd.items())


@pytest.mark.parametrize("name", ["f2t2_in_one", "one_at_f2"])
def test_checkpoints_resume_across_meshes(runs, name):
    tmp = runs["tmp"]
    rows = _rows(os.path.join(tmp, name))
    assert [int(r["step"]) for r in rows] == list(range(1, STEPS + 1))
    _close(rows[CKPT_STEP:], _rows(os.path.join(tmp, "one"))[CKPT_STEP:])
    _same_state(tmp, "one", name, STEPS)
    if name == "f2t2_in_one":
        assert runs["in_one"]["start_step"] == CKPT_STEP


# ---- refusals -------------------------------------------------------------------


@pytest.mark.parametrize("argv,match", [
    (["--num_processes", "3", "--mesh_fsdp", "2"], "--num_processes 3 does not divide"),
    (["--mesh_tensor", "2"], "--num_processes 1 does not divide"),
    (["--mesh_fsdp", "0"], "must be >= 1"),
])
def test_mesh_refusals(tmp_path, argv, match):
    with pytest.raises(ValueError, match=match):
        train.main(["--device", "cpu", "-b", TINY_CONFIG, "-l", str(tmp_path), *argv])


def test_a_batch_that_does_not_split_is_refused(tmp_path):
    """A global batch of 2 over 4 fsdp row blocks, in a gloo group of four
    processes: every process raises before it builds."""
    procs = _launch(["--device", "cpu", "-b", TINY_CONFIG, "-l", str(tmp_path)], 4,
                    "--mesh_fsdp", "4")
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode != 0 for p in procs)
    assert all("does not split over data x fsdp = 4 row blocks" in o for o in outs)
    with pytest.raises(ValueError, match="does not split"):
        distributed.check_batch(3, 2)

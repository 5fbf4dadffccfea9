"""The port's parameter key space, its engine entry point and its import
hygiene.

The flagship engine, built by the port from configs/infer_kubric.yaml on the
meta device (no memory, no init compute), must have exactly the reference
checkpoint's keys and shapes (tests/_golden/ref_key_manifest.json) outside
the CLIP tower, so a released state dict loads with strict=True. The
manifest lacks the tower (the reference's open_clip could not be built where
it was taken); its keys are held against the ones the port's converter
derives from the JAX tower's parameter tree.
"""

import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.models.embedders import FrozenOpenCLIPImagePredictionEmbedder as JCLIPEmbedder
from gcd_tpu_torch.engine.build import load_engine
from gcd_tpu_torch.io.convert import (
    _iter_tree_paths,
    flax_path_to_torch_key,
    gcd_clip_rename,
    torch_layout_from_flax,
)
from gcd_tpu_torch.utils.config import instantiate_from_config, load_config
from tests.torch_port_helpers import TINY_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIXES = {"model.diffusion_model.": 1432, "first_stage_model.decoder.": 266,
            "first_stage_model.encoder.": 106, "conditioner.embedders.3.": 248,
            "conditioner.embedders.5.": 2}
CLIP_PREFIX = "conditioner.embedders.0."


def _manifest():
    with open(os.path.join(REPO, "tests", "_golden", "ref_key_manifest.json")) as f:
        keys = json.load(f)["keys"]
    return {k: tuple(v) for k, v in keys.items() if k.startswith(tuple(PREFIXES))}


def _flagship_meta():
    cfg = load_config(os.path.join(REPO, "configs", "infer_kubric.yaml"))
    with torch.device("meta"):
        return instantiate_from_config(cfg["model"]), cfg


def _clip_keys_from_jax(cfg):
    """{torch key: shape} of the CLIP embedder, from the JAX module's param
    shapes through the port's converter."""
    emb = cfg["model"]["params"]["conditioner_config"]["params"]["emb_models"][0]
    jmod = JCLIPEmbedder(**emb["params"])
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 256, 384, 3))))["params"]
    out = {}
    for path, leaf in _iter_tree_paths(shapes):
        key, kind = flax_path_to_torch_key(path)
        shape = torch_layout_from_flax(np.broadcast_to(np.float32(0), leaf.shape), kind).shape
        out[gcd_clip_rename(CLIP_PREFIX + key)] = tuple(shape)
    return out


def test_flagship_state_dict_matches_reference_keys():
    engine, cfg = _flagship_meta()
    got = {k: tuple(v.shape) for k, v in engine.state_dict().items()}
    want = _manifest()
    for prefix, n in PREFIXES.items():
        assert sum(k.startswith(prefix) for k in want) == n
    want.update(_clip_keys_from_jax(cfg))
    assert sum(k.startswith(CLIP_PREFIX + "open_clip.model.visual.transformer.resblocks.")
               for k in want) == 32 * 12
    assert sorted(set(want) - set(got)) == []
    assert sorted(set(got) - set(want)) == []
    assert {k: got[k] for k in want if got[k] != want[k]} == {}


@pytest.fixture(scope="module")
def pardom_clip_keys():
    """The CLIP embedder's keys; the PD configs' CLIP is the flagship's."""
    return _clip_keys_from_jax(load_config(os.path.join(REPO, "configs", "infer_pardom.yaml")))


@pytest.mark.parametrize("config", ["configs/infer_pardom.yaml",
                                    "pretrained/pardom_gradual_semantic.yaml",
                                    "configs/train_pardom_semantic.yaml"])
def test_pardom_configs_state_dict_matches_reference_keys(config, pardom_clip_keys):
    """The ParallelDomain configs build the base conditioner (no camera
    embedder) and a UNet with a 768-wide label embedding and no
    aux_label_emb: the reference key space less those two, so a released
    PD checkpoint loads with strict=True."""
    cfg = load_config(os.path.join(REPO, config))
    with torch.device("meta"):
        engine = instantiate_from_config(cfg["model"])
    got = {k: tuple(v.shape) for k, v in engine.state_dict().items()}
    want = {k: v for k, v in _manifest().items()
            if not k.startswith(("conditioner.embedders.5.", "model.diffusion_model.aux_label_emb."))}
    want.update(pardom_clip_keys)
    assert len(engine.conditioner.embedders) == 5
    assert sorted(set(want) - set(got)) == [] and sorted(set(got) - set(want)) == []
    assert {k: got[k] for k in want if got[k] != want[k]} == {}
    assert got["model.diffusion_model.label_emb.0.0.weight"] == (1280, 768)


def test_load_engine_puts_the_model_on_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_engine(TINY_CONFIG)
    engine = load_engine(TINY_CONFIG, device="cpu")
    params = list(engine.parameters())
    assert {p.device.type for p in params} == {"cpu"}
    assert {p.dtype for p in params} == {torch.bfloat16}
    assert not engine.training
    again = load_engine(TINY_CONFIG, device="cpu")  # seeded: the same weights
    assert all(torch.equal(a, b) for a, b in zip(params, again.parameters()))


def test_load_engine_state_dict_is_strict():
    engine = load_engine(TINY_CONFIG, device="cpu", dtype=torch.float32)
    sd = {k: torch.full_like(v, 0.5) for k, v in engine.state_dict().items()}
    loaded = load_engine(TINY_CONFIG, device="cpu", dtype=torch.float32, state_dict=sd)
    assert all(bool((p == 0.5).all()) for p in loaded.parameters())
    sd.pop(next(iter(sd)))
    with pytest.raises(RuntimeError, match="Missing key"):
        load_engine(TINY_CONFIG, device="cpu", dtype=torch.float32, state_dict=sd)


def _chip_smoke_imports():
    """Every module chip_smoke.py imports, at top level or in a function."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return sorted(mods)


_NO_JAX = (
    "import sys\n"
    "bad = sorted(m for m in sys.modules if m in ('jax', 'gcd_tpu', 'cv2', 'imageio',\n"
    "                                              'matplotlib', 'PIL')\n"
    "             or m.startswith(('jax.', 'flax', 'optax', 'gcd_tpu.', 'orbax', 'cv2.',\n"
    "                              'imageio.', 'matplotlib.', 'PIL.')))\n"
    "assert not bad, bad\n"
)


def _run_no_jax(code: str) -> None:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code + _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_port_imports_no_jax():
    """Importing every gcd_tpu_torch module loads neither JAX nor any module
    of the JAX package, nor flax, optax, cv2, imageio, matplotlib, PIL or
    orbax (the card's machine has none of them); nor does drawing with the
    copied colour tables and glyph atlas, whose generator
    (gcd_tpu_torch/assets/make_assets.py, which needs cv2 and matplotlib)
    is no module of the package."""
    _run_no_jax(
        "import importlib, pkgutil\n"
        "import gcd_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(gcd_tpu_torch.__path__, "
        "'gcd_tpu_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "assert len(mods) >= 40, mods\n"
        "training = {'gcd_tpu_torch.engine.trainer', 'gcd_tpu_torch.diffusion.loss',\n"
        "            'gcd_tpu_torch.diffusion.sigma_sampling',\n"
        "            'gcd_tpu_torch.diffusion.weighting', 'gcd_tpu_torch.ops.recompute',\n"
        "            'gcd_tpu_torch.train', 'gcd_tpu_torch.data.common',\n"
        "            'gcd_tpu_torch.data.geometry', 'gcd_tpu_torch.data.loader',\n"
        "            'gcd_tpu_torch.data.kubric', 'gcd_tpu_torch.data.fake',\n"
        "            'gcd_tpu_torch.native', 'gcd_tpu_torch.engine.image_logger',\n"
        "            'gcd_tpu_torch.data.pardom', 'gcd_tpu_torch.data.png',\n"
        "            'gcd_tpu_torch.engine.ema', 'gcd_tpu_torch.engine.lr_schedule',\n"
        "            'gcd_tpu_torch.models.lora', 'gcd_tpu_torch.parallel.distributed'}\n"
        "serving = {'gcd_tpu_torch.ops.fused_gn_conv', 'gcd_tpu_torch.engine.server',\n"
        "           'gcd_tpu_torch.engine.bundle', 'gcd_tpu_torch.serve',\n"
        "           'gcd_tpu_torch.io.checkpoint'}\n"
        "evaluation = {'gcd_tpu_torch.infer', 'gcd_tpu_torch.test',\n"
        "              'gcd_tpu_torch.eval_utils', 'gcd_tpu_torch.utils.metrics',\n"
        "              'gcd_tpu_torch.galleries', 'gcd_tpu_torch.utils.draw'}\n"
        "sharded = {'gcd_tpu_torch.engine.serving', 'gcd_tpu_torch.engine.export',\n"
        "           'gcd_tpu_torch.parallel.mesh', 'gcd_tpu_torch.parallel.frames'}\n"
        "entries = training | serving | evaluation | sharded\n"
        "assert entries <= set(mods), sorted(entries - set(mods))\n"
        "assert not any(m.startswith('gcd_tpu_torch.assets') for m in mods), mods\n"
        "import numpy as np\n"
        "from gcd_tpu_torch.utils.draw import colormap, draw_text\n"
        "colormap('plasma', np.linspace(0, 1, 5)); colormap('magma', np.linspace(0, 1, 5))\n"
        "assert draw_text(np.zeros((40, 60, 3), np.float32), 'Aq', (5, 26)).max() > 0\n")


def test_chip_smoke_imports_no_jax():
    """The same for chip_smoke.py and everything it imports, at top level or
    inside its functions."""
    mods = _chip_smoke_imports()
    assert {"gcd_tpu_torch.engine.build", "gcd_tpu_torch.engine.trainer",
            "gcd_tpu_torch.engine.server", "gcd_tpu_torch.engine.bundle",
            "gcd_tpu_torch.serve", "gcd_tpu_torch.data.fake",
            "gcd_tpu_torch.data.kubric", "gcd_tpu_torch.train",
            "gcd_tpu_torch.data.pardom", "gcd_tpu_torch.data.png", "gcd_tpu_torch.infer",
            "gcd_tpu_torch.test", "gcd_tpu_torch.eval_utils", "gcd_tpu_torch.galleries",
            "gcd_tpu_torch.utils.draw", "gcd_tpu_torch.engine.serving",
            "gcd_tpu_torch.engine.export"} <= set(mods)
    _run_no_jax("import importlib, chip_smoke\n"
                + "".join(f"importlib.import_module({m!r})\n" for m in mods))

"""The port's parameter key space and import hygiene.

The flagship VideoUNet and VideoDecoder, built by the port from
configs/infer_kubric.yaml on the meta device (no memory, no init compute),
must have exactly the reference checkpoint's model.diffusion_model.* and
first_stage_model.decoder.* keys and shapes (tests/_golden/
ref_key_manifest.json), so a released state dict loads with strict=True.
"""

import json
import os
import subprocess
import sys

import torch

from gcd_tpu_torch.utils.config import instantiate_from_config, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIXES = {"model.diffusion_model.": 1432, "first_stage_model.decoder.": 266}


def _manifest():
    with open(os.path.join(REPO, "tests", "_golden", "ref_key_manifest.json")) as f:
        keys = json.load(f)["keys"]
    return {k: tuple(v) for k, v in keys.items() if k.startswith(tuple(PREFIXES))}


def test_flagship_state_dict_matches_reference_keys():
    cfg = load_config(os.path.join(REPO, "configs", "infer_kubric.yaml"))
    with torch.device("meta"):
        engine = instantiate_from_config(cfg["model"])
    got = {k: tuple(v.shape) for k, v in engine.state_dict().items()}
    want = _manifest()
    for prefix, n in PREFIXES.items():
        assert sum(k.startswith(prefix) for k in want) == n
    assert sorted(set(want) - set(got)) == []
    assert sorted(set(got) - set(want)) == []
    assert {k: got[k] for k in want if got[k] != want[k]} == {}


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gcd_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(gcd_tpu_torch.__path__, 'gcd_tpu_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "assert len(mods) >= 20, mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax')))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]

"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import subprocess
import sys

import pytest

from gcd_bench.harness import BENCH_DIR, ROOT
from gcd_bench.run import forbidden_modules


@pytest.mark.parametrize("name, flagged", [("gcd_tpu", True), ("gcd_tpu.models.unet", True),
                                           ("jax", True), ("jaxlib.xla_client", True),
                                           ("flax.linen", True), ("gcd_tpu_torch", False),
                                           ("gcd_tpu_torch.engine", False), ("jaxtyping", False)])
def test_forbidden_names_compared_whole(monkeypatch, name, flagged):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in forbidden_modules()) == flagged


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH_DIR / "reference").glob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"gcd_tpu_torch", "gcd_tpu", "jax", "jaxlib", "flax"}, path.name


def test_no_bench_file_imports_jax_or_the_jax_package():
    for path in sorted(BENCH_DIR.rglob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"gcd_tpu", "jax", "jaxlib", "flax", "bench", "chip_smoke",
                           "scripts"}, path


def test_a_run_loads_no_jax():
    code = ("import sys; import gcd_bench.run, gcd_bench.control, gcd_bench.flops; "
            "import gcd_bench.drivers.serve, gcd_bench.drivers.clip, gcd_bench.drivers.train; "
            "import gcd_tpu_torch.engine.server, gcd_tpu_torch.engine.trainer, "
            "gcd_tpu_torch.engine.build; "
            "print(gcd_bench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_alone_loads_no_program():
    code = ("import sys; import gcd_bench.reference.engine; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gcd_tpu_torch', 'gcd_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

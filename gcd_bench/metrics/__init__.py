"""One reader a metric, in the file named as the metric in BENCHMARK.json
(`<name>.py`), with `read(run) -> float or None` (None: nothing to read,
the metric is left out of the result line). The harness finds a reader by
its metric's name; a new metric adds its file and its entry."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable

_HERE = Path(__file__).resolve().parent


def reader(name: str) -> Callable:
    path = _HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"gcd_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

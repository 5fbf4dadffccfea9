"""Operations and bytes of each `gcd::` op call, from its shapes.

One file per op, named as the op (`gcd::<name>` -> `<name>.py`), with
`count(shapes, dtypes, scalars, frames) -> (flops, bytes)`: the op's
mathematical work, each input read once and each output written once,
whatever kernel implements it. `shapes` are the call's argument shapes
(`[]` for a non-tensor), `dtypes` their dtype names where the profiler
records them, `scalars` the non-tensor arguments where it records them,
`frames` the clip length, for an op whose frame count is an argument the
profiler may not record. A new op adds its file; an op without one is
left out of the roofline share.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

_HERE = Path(__file__).resolve().parent
_CACHE: Dict[str, Optional[Callable]] = {}


def numel(shape: Sequence[int]) -> int:
    return int(math.prod(shape)) if shape else 0


def itemsize(dtypes, i: int, default: int = 2) -> int:
    """Bytes an element of argument i: from the recorded dtype name, else
    `default` (bf16, the dtype the configurations serve and train in)."""
    if not dtypes or i >= len(dtypes) or not dtypes[i]:
        return default
    name = str(dtypes[i]).lower()
    for key, size in (("double", 8), ("float64", 8), ("half", 2), ("bfloat16", 2),
                      ("float16", 2), ("float", 4), ("int64", 8), ("long", 8), ("bool", 1)):
        if key in name:
            return size
    return default


def tensor_bytes(shapes, dtypes, i: int, default: int = 2) -> int:
    return numel(shapes[i]) * itemsize(dtypes, i, default)


def counter(op: str) -> Optional[Callable]:
    """The `count` of op `op`, or None where it has no file."""
    if op not in _CACHE:
        path = _HERE / f"{op}.py"
        fn = None
        if path.is_file():
            spec = importlib.util.spec_from_file_location(f"gcd_bench.ops.{op}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            fn = mod.count
        _CACHE[op] = fn
    return _CACHE[op]

"""Kernel switches for the port's CUDA kernels.

Same thread-local pattern as gcd_tpu/ops/dispatch.py (kernel_flags /
kernel_enabled), reduced to the kernels the port has:

  flash      K1, spatial multi-head self-attention (ops/flash_attention.py)
  tattn      K2, frame-axis temporal attention (ops/temporal_attention.py)
  fused_mlp  K3, fused GEGLU feed-forward (ops/fused_mlp.py)
  fused_gn   K4, GroupNorm(+SiLU) (ops/fused_norm.py group_norm)
  gn_stats   K5, per-group sums, the first pass of K4 on large groups
             (ops/fused_norm.py group_stats)

All default to on. `with kernel_flags(flash=False): ...` makes the wrapper
run its plain PyTorch version on CUDA tensors too, which is how the kernel
on/off A/B in chip_smoke.py is made. There are no environment overrides.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

_DEFAULTS = {"flash": True, "tattn": True, "fused_mlp": True, "fused_gn": True,
             "gn_stats": True}

_tls = threading.local()


def _stack():
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def kernel_enabled(name: str) -> bool:
    """Effective value of a kernel switch for the calling thread."""
    for frame in reversed(_stack()):
        if name in frame:
            return frame[name]
    return _DEFAULTS[name]


@contextmanager
def kernel_flags(**flags: bool):
    """Thread-local switch overrides for the duration of the block
    (nestable; the innermost wins)."""
    unknown = set(flags) - set(_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown kernel flag(s) {sorted(unknown)}; "
                         f"known: {sorted(_DEFAULTS)}")
    stack = _stack()
    stack.append(dict(flags))
    try:
        yield
    finally:
        stack.pop()

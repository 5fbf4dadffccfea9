"""Kernel switches for the port's CUDA kernels.

Same thread-local pattern as gcd_tpu/ops/dispatch.py (kernel_flags /
kernel_enabled), reduced to the kernels the port has:

  flash      K1, spatial multi-head self-attention (ops/flash_attention.py)
  flash_bwd  K6, its backward (ops/flash_attention.py flash_attention_bwd)
  tattn      K2, frame-axis temporal attention (ops/temporal_attention.py)
  fused_mlp  K3, fused GEGLU feed-forward (ops/fused_mlp.py)
  fused_gn   K4, GroupNorm(+SiLU) (ops/fused_norm.py group_norm)
  gn_stats   K5, per-group sums, the first pass of K4's split path
             and of K7 (ops/fused_norm.py group_stats)
  fused_gn_conv
             K7, GroupNorm -> SiLU -> 3x3 conv in one kernel at the 2D
             ResBlocks' in_layers / out_layers (ops/fused_gn_conv.py,
             models/resblock.py)

All default to on. The JAX package parks `fused_gn_conv` off by default for
a TPU reason: its opaque Pallas boundary costs XLA the epilogue fusions
around the ResBlock (gcd_tpu/models/resblock.py:104-109). The port runs
eagerly with no such fusions, and runs every kernel at every site it serves. `with kernel_flags(flash=False): ...` makes the wrapper
run its plain PyTorch version on CUDA tensors too, which is how the kernel
on/off A/B in chip_smoke.py is made. There are no environment overrides.

The switches are per thread, and PyTorch runs a CUDA backward on an autograd
thread of its own, where the stack is empty. So whatever runs in a backward
is told its path explicitly: the attention Function records `flash_bwd` at
forward, and the UNet's rematerialised blocks re-enter the caller's
`current_flags()` for their recompute (models/unet.py).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

_DEFAULTS = {"flash": True, "flash_bwd": True, "tattn": True, "fused_mlp": True,
             "fused_gn": True, "gn_stats": True, "fused_gn_conv": True}

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


def current_flags() -> dict:
    """Every switch's effective value for the calling thread."""
    return {name: kernel_enabled(name) for name in _DEFAULTS}


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

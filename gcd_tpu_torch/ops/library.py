"""The port's kernels as torch.library custom ops in the `gcd` namespace.

Each kernel wrapper (ops/flash_attention.py, temporal_attention.py,
fused_mlp.py, fused_norm.py, fused_gn_conv.py) registers what it returns
as one op with three implementations:

  CUDA  the wrapper's launch code: operand checks, per-stream scratch, the
        kernel's C entry point, the wrapper's `launches` count;
  CPU   the plain PyTorch version;
  fake  the output's shape, dtype and strides: on a CUDA tensor the layout
        the kernel writes, on any other the plain version's, found by
        running the plain version on the fake tensors.

The wrapper makes the `kernel_flags` choice at call time: with its switch
on it calls the op (on the CPU too, so that a CPU export records `gcd::`
nodes), with it off it runs the plain version. Eager calls and
torch.export take the same path, so an exported program calls the ops,
and counts launches, as the eager engine does.

The ops are registered through the low-level `torch.library.Library`
API, whose dispatch costs less host time a call than `custom_op`'s Python
wrapper. No op declares a mutation: the scratch buffers are not arguments.
"""

from __future__ import annotations

from typing import Callable

import torch

LIB = torch.library.Library("gcd", "DEF")


def define(schema: str, cuda: Callable, cpu: Callable, cuda_fake: Callable) -> Callable:
    """Define `gcd::<schema>` with its CUDA and CPU implementations; its
    fake implementation is `cuda_fake` for CUDA tensors and `cpu` (the plain
    version) run on the fake tensors otherwise. Returns the overload's
    dispatcher entry (`OpOverload._op`: the same dispatch, traced by
    torch.export alike, without OpOverload.__call__'s Python frame)."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")

    def fake(*args):
        return cuda_fake(*args) if args[0].is_cuda else cpu(*args)

    torch.library.register_fake(f"gcd::{name}", fake, lib=LIB)
    return getattr(torch.ops.gcd, name).default._op

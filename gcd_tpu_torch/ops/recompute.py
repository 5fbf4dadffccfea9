"""The autograd Function of the kernels whose JAX backward is XLA, not Pallas.

K2, K3 and K4 each have a custom_vjp in the JAX package whose backward is
the vjp of the plain computation, recomputed from the saved inputs
(gcd_tpu/ops/temporal_attention.py `_temporal_bwd`, fused_mlp.py `_bwd`,
fused_norm.py `_bwd`). `PlainGradient` is that rule: its forward is the
kernel's wrapper, its backward the gradient of the plain PyTorch version,
recomputed under `torch.enable_grad()`. The same Function runs on the CPU,
where the forward is the plain version too.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import torch


class PlainGradient(torch.autograd.Function):
    """apply(run, plain, *tensors): forward `run(*tensors)`; backward the
    gradient of `plain(*tensors)` w.r.t. the tensors that need one."""

    @staticmethod
    def forward(ctx, run: Callable, plain: Callable, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return run(*tensors)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = ctx.plain(*inputs)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(inputs, need) if n],
                                             grad))
        return (None, None, *(next(grads) if n else None for n in need))


def plain_gradient(run: Callable, plain: Callable, tensors: Tuple[torch.Tensor, ...],
                   **static):
    """PlainGradient.apply over run(*tensors, **static) and
    plain(*tensors, **static) where a gradient is asked for; else
    run(*tensors, **static) alone, which gives the same values without the
    Function's host time (about 20 us a call on the H100 machine's host,
    ahead of every kernel launch on the inference path) or the partials'."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return PlainGradient.apply(partial(run, **static), partial(plain, **static), *tensors)
    return run(*tensors, **static)

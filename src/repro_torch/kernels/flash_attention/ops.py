"""Public wrapper for flash attention, differentiable.

``attention`` takes the kernel wrapper (the CUDA kernel for CUDA
tensors, the plain version for CPU tensors) or the plain version, and
carries the JAX package's custom VJP
(``repro/kernels/flash_attention/ops.py``): the forward runs through
the kernel and saves q, k, v; the backward recomputes the output
through the plain ``mha_ref`` and returns that recompute's gradients.
There is no backward kernel, in the JAX package or here.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention
from .ref import mha_ref


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale, impl):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, sm_scale)
        if impl == "pallas" or q.device.type == "cuda":
            return flash_attention(q, k, v, causal=causal, window=window,
                                   sm_scale=sm_scale)
        return mha_ref(q, k, v, causal=causal, window=window,
                       sm_scale=sm_scale)

    @staticmethod
    def backward(ctx, g):
        causal, window, sm_scale = ctx.mask
        q, k, v = (x.detach().requires_grad_(True)
                   for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = mha_ref(q, k, v, causal=causal, window=window,
                          sm_scale=sm_scale)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              sm_scale: Optional[float] = None,
              impl: str = "pallas") -> torch.Tensor:
    """``impl="pallas"`` takes the kernel wrapper; any other impl the
    plain version, except on CUDA tensors, which always launch the
    kernel.  Gradients reach q, k and v through the recompute
    backward."""
    return _Attention.apply(q, k, v, causal, window, sm_scale, impl)

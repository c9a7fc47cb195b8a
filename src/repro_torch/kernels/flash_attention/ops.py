"""Public wrapper for flash attention, differentiable.

``attention`` takes the kernel wrapper (the CUDA kernel for CUDA
tensors, the plain version for CPU tensors) or the plain version, and
carries the JAX package's custom VJP
(``repro/kernels/flash_attention/ops.py``): the forward runs through
the kernel and saves q, k, v; the backward recomputes the output
through the plain ``mha_ref`` and returns that recompute's gradients.
There is no backward kernel, in the JAX package or here.

On an SPMD rank q, k and v arrive as DTensors (tensor parallelism over
the heads).  :func:`attention` then keeps the batch where it is sharded,
splits the heads over every other mesh dim whose size divides both
``n_heads`` and ``n_kv_heads`` (so each rank's q heads read exactly its
own kv heads) and replicates them elsewhere, and runs the Function on
each rank's local tensors: on the card the kernel runs on the rank's
local heads.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

from .kernel import flash_attention
from .ref import mha_ref


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale, impl):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, sm_scale)
        if impl == "pallas" or q.device.type == "cuda" \
                or isinstance(q, FakeTensor):
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
    kernel, and on fake tensors, which always trace it.  Gradients
    reach q, k and v through the recompute backward."""
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        return _attention_local(q, k, v, causal, window, sm_scale, impl)
    return _Attention.apply(q, k, v, causal, window, sm_scale, impl)


def _head_placements(q, n_kv: int):
    """(q placements, kv placements) for (B, H, T, D) DTensors: batch
    shards stay, heads split where the mesh dim divides both head
    counts, everything else replicated."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    qp, kvp = [], []
    for i, pl in enumerate(q.placements):
        size = mesh.size(i)
        if isinstance(pl, Shard) and pl.dim == 0:
            qp.append(Shard(0))
            kvp.append(Shard(0))
        elif q.shape[1] % size == 0 and n_kv % size == 0 \
                and Shard(1) not in qp:
            qp.append(Shard(1))
            kvp.append(Shard(1))
        else:
            qp.append(Replicate())
            kvp.append(Replicate())
    return tuple(qp), tuple(kvp)


def _attention_local(q, k, v, causal, window, sm_scale, impl):
    from torch.distributed.tensor import DTensor

    qp, kvp = _head_placements(q, k.shape[1])
    mesh = q.device_mesh
    q = q.redistribute(mesh, qp)
    k = k.redistribute(mesh, kvp)
    v = v.redistribute(mesh, kvp)
    out = _Attention.apply(q.to_local(), k.to_local(), v.to_local(),
                           causal, window, sm_scale, impl)
    return DTensor.from_local(out, mesh, qp, run_check=False,
                              shape=q.shape, stride=q.stride())

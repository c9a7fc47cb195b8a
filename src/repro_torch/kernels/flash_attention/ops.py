"""Public wrapper for flash attention, differentiable.

``attention`` takes the kernel wrapper (the CUDA kernel for CUDA
tensors, the plain version for CPU tensors) or the plain version, and
carries the JAX package's custom VJP
(``repro/kernels/flash_attention/ops.py``): the forward runs through
the kernel and saves q, k, v; the backward recomputes the output
through the plain ``mha_ref`` and returns that recompute's gradients.
There is no backward kernel, in the JAX package or here.

On an SPMD rank q, k and v arrive as DTensors (tensor parallelism over
the heads).  :func:`attention` then places them as the JAX package's
rules do, whatever placements they arrive with: the batch over "pod"
and "data" where it divides, and the heads over the mesh dim that the
rules give them ("model"; on a mesh with no such dim, the first other
dim) where
its size divides both ``n_heads`` and ``n_kv_heads`` (so each rank's q
heads read exactly its own kv heads).  A batch dim that the batch leaves
free ("pod" or "data" under a batch smaller than the pod) replicates the
heads, as in the JAX package.  Where that heads' dim of n ranks cannot
split the kv heads but n is a multiple of them, the r = n / Hkv ranks
that share a kv head split its work as decode does
(``models.common.replica_plan``): its g q heads by d = gcd(g, r), and
the queries by c = r / d.  Each rank
narrows its replica of k and v to its kv head.  With c = 1 (granite-8b:
2 q heads a rank inside a group of 4) the ranks' q heads are a plain
split of the heads.  Otherwise (gemma3-1b, llama4-scout, phi4-mini) the
queries are cut into 2c chunks and rank s of the c takes chunks s and
2c - 1 - s (zig-zag), so that every rank gets the same causal work;
each chunk attends its key prefix through the kernel, whose query rows
sit at the end of the keys it is given, and the chunks are all-gathered
into the (B, Hq, T, D) output that ``wo`` takes.  q, k and v take their
gradients on each rank's slices only, as partial sums over that mesh
dim (``Partial``).  Elsewhere the heads are replicated, and every rank
runs the kernel on them.
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
    """(q placements, kv placements) for (B, H, T, D) DTensors, as the
    JAX package's rules place them, whatever placements q arrives with:
    the batch over "pod" and "data" where it divides
    (``batch_mesh_dims``), the heads over the heads' mesh dim
    (``heads_mesh_dim``: "model", or on a mesh with no such dim the first
    other dim) where its size divides both head counts, everything else
    replicated."""
    from torch.distributed.tensor import Replicate, Shard

    from ...models.common import batch_mesh_dims, heads_mesh_dim

    mesh = q.device_mesh
    heads_dim = heads_mesh_dim(mesh)
    batch = batch_mesh_dims(mesh, q.shape[0])
    qp, kvp = [], []
    for i in range(mesh.ndim):
        size = mesh.size(i)
        if i in batch:
            qp.append(Shard(0))
            kvp.append(Shard(0))
        elif heads_dim in (None, i) and q.shape[1] % size == 0 \
                and n_kv % size == 0 and Shard(1) not in qp:
            qp.append(Shard(1))
            kvp.append(Shard(1))
        else:
            qp.append(Replicate())
            kvp.append(Replicate())
    return tuple(qp), tuple(kvp)


def _replica_route(q, n_kv: int, qp, kvp, causal: bool):
    """(mesh dim, (r, d, c)) where the ranks of the heads' mesh dim
    (``heads_mesh_dim``; any dim on a mesh with none), replicating the
    heads, share each kv head (``replica_plan``), or None.  The query
    chunks need a causal mask and 2c equal chunks."""
    from torch.distributed.tensor import Replicate, Shard

    from ...models.common import heads_mesh_dim, replica_plan

    if Shard(1) in kvp:
        return None
    heads_dim = heads_mesh_dim(q.device_mesh)
    for i, pl in enumerate(qp):
        if not isinstance(pl, Replicate) or heads_dim not in (None, i):
            continue
        plan = replica_plan(n_kv, q.shape[1] // n_kv, q.device_mesh.size(i))
        if plan is None or plan[0] == 1:
            continue
        if plan[2] == 1 or (causal and q.shape[2] % (2 * plan[2]) == 0):
            return i, plan
    return None


def _attention_local(q, k, v, causal, window, sm_scale, impl):
    from torch.distributed.tensor import DTensor, Partial, Shard

    qp, kvp = (list(x) for x in _head_placements(q, k.shape[1]))
    mesh = q.device_mesh
    route = _replica_route(q, k.shape[1], qp, kvp, causal)
    if route is None:
        q = q.redistribute(mesh, qp)
        k = k.redistribute(mesh, kvp)
        v = v.redistribute(mesh, kvp)
        out = _Attention.apply(q.to_local(), k.to_local(), v.to_local(),
                               causal, window, sm_scale, impl)
        return DTensor.from_local(out, mesh, qp, run_check=False,
                                  shape=q.shape, stride=q.stride())
    dim, (r, d, c) = route
    j = mesh.get_local_rank(dim)
    head = j // r
    if c == 1:
        qp[dim] = Shard(1)
    q = q.redistribute(mesh, qp)
    k = k.redistribute(mesh, kvp)
    v = v.redistribute(mesh, kvp)
    # each rank's gradient covers its own slices: a partial sum over dim
    kgp = [Partial() if i == dim else pl for i, pl in enumerate(kvp)]
    k_loc = k.to_local(grad_placements=kgp).narrow(1, head, 1)
    v_loc = v.to_local(grad_placements=kgp).narrow(1, head, 1)
    if c == 1:
        out = _Attention.apply(q.to_local(), k_loc, v_loc, causal, window,
                               sm_scale, impl)
        return DTensor.from_local(out, mesh, qp, run_check=False,
                                  shape=q.shape, stride=q.stride())
    qgp = [Partial() if i == dim else pl for i, pl in enumerate(qp)]
    q_loc = q.to_local(grad_placements=qgp)
    group = q.shape[1] // k.shape[1]
    per = group // d
    start = head * group + (j % r) // c * per
    outs = [_Attention.apply(q_loc[:, start:start + per, a:a + size],
                             k_loc[:, :, lo:hi], v_loc[:, :, lo:hi], causal,
                             window, sm_scale, impl)
            for a, size, lo, hi in zigzag_chunks(q.shape[2], k.shape[2], c,
                                                 j % c, window)]
    return _gather_chunks(torch.stack(outs, dim=2), mesh, qp, dim,
                          (k.shape[1], d, c), q.shape)


def zigzag_chunks(t: int, s: int, c: int, shard: int,
                  window: Optional[int]) -> list:
    """The two causal query chunks of ``shard`` of ``c`` over T = ``t``
    rows (2c chunks of T / 2c; chunks ``shard`` and 2c - 1 - ``shard``)
    and S = ``s`` keys: ``(first row, rows, first key, end key)`` each,
    the keys being the chunk's prefix, from its first row's window.  The
    kernel sees its rows at the end of those keys, where they sit."""
    size = t // (2 * c)
    out = []
    for chunk in (shard, 2 * c - 1 - shard):
        a = chunk * size
        lo = 0 if window is None else max(0, s - t + a - window + 1)
        out.append((a, size, lo, s - t + a + size))
    return out


def _gather_chunks(piece, mesh, qp, dim: int, split, shape):
    """The (B, Hq, T, D) output from every rank's ``piece`` (B, per, 2,
    T / 2c, D) of its q heads and its two query chunks: an all-gather over
    mesh dim ``dim``, whose rank j = (h r + p c + s) holds kv head h's q
    part p at chunks s and 2c - 1 - s; ``split`` is (Hkv, d, c)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pls = [Shard(0) if i == dim else
           Shard(pl.dim + 1) if isinstance(pl, Shard) else pl
           for i, pl in enumerate(qp)]
    whole = [Replicate() if i == dim else pl for i, pl in enumerate(pls)]
    every = DTensor.from_local(piece[None], mesh, pls, run_check=False
                               ).redistribute(mesh, whole).to_local()
    n_kv, d, c = split
    b, per, _, size, hd = piece.shape
    every = every.view(n_kv, d, c, b, per, 2, size, hd).permute(
        3, 0, 1, 4, 5, 2, 6, 7)            # (B, Hkv, d, per, 2, c, T/2c, D)
    out = torch.cat([every[:, :, :, :, 0], every[:, :, :, :, 1].flip(4)],
                    dim=4).reshape(b, n_kv * d * per, 2 * c * size, hd)
    return DTensor.from_local(out, mesh, [Replicate() if i == dim else pl
                                          for i, pl in enumerate(qp)],
                              run_check=False, shape=shape,
                              stride=out.stride())

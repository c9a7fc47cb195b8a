"""Public wrapper for flash-decode (inference only: no gradient).

On an SPMD rank q, the cache and ``kv_len`` may arrive as DTensors (a
decode over a cache placed by ``launch.sharding.cache_shardings``).
:func:`decode` then follows the cache's placements, so the cache never
moves: where the cache splits the batch or the kv heads over a mesh
dim, q (and ``kv_len`` for the batch) split the same way.  Where the
cache is replicated over a mesh dim that cannot split the kv heads (8
kv heads over 16 ranks) but can split the q heads so that each rank's
lie within one kv head's group, the ranks split the q heads and each
reads its one kv head from its replica of the cache.  Elsewhere q is
replicated.  Every rank runs the kernel on its own rows and heads.  A
cache split along its sequence (the sequence-parallel ``long_500k``
cells) is gathered whole on that mesh dim first: the kernel returns
normalised rows and no log-sum-exp, so partial results over key shards
cannot be merged.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import decode_attention
from .ref import decode_ref


def decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_len: torch.Tensor, *, sm_scale: Optional[float] = None,
           window: Optional[int] = None,
           impl: str = "pallas") -> torch.Tensor:
    """``impl="pallas"`` takes the kernel wrapper; any other impl the
    plain version, except on CUDA tensors, which always launch the
    kernel, and on fake tensors, which always trace it."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor

    if isinstance(k, DTensor):
        return _decode_local(q, k, v, kv_len, sm_scale, window, impl)
    if impl == "pallas" or q.device.type == "cuda" \
            or isinstance(q, FakeTensor):
        return decode_attention(q, k, v, kv_len, sm_scale=sm_scale,
                                window=window)
    return decode_ref(q, k, v, kv_len, sm_scale=sm_scale, window=window)


def _decode_local(q, k, v, kv_len, sm_scale, window, impl):
    """``decode`` on each rank's local rows and heads of a DTensor
    cache; returns a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = k.device_mesh
    hq, hkv = q.shape[1], k.shape[1]
    group = hq // hkv
    heads_split = any(isinstance(pl, Shard) and pl.dim == 1
                      for pl in k.placements)
    kvp, qp, lp = [], [], []
    within = None          # (mesh dim, q heads a rank) inside one kv head
    for i, pl in enumerate(k.placements):
        n = mesh.size(i)
        if isinstance(pl, Shard) and pl.dim in (0, 1):
            kvp.append(pl)
            qp.append(Shard(pl.dim))
            lp.append(Shard(0) if pl.dim == 0 else Replicate())
            continue
        kvp.append(Replicate())
        lp.append(Replicate())
        if not heads_split and within is None and hq % n == 0 \
                and group % (hq // n) == 0:
            within = (i, hq // n)
            qp.append(Shard(1))
        else:
            qp.append(Replicate())
    if not isinstance(q, DTensor):
        q = DTensor.from_local(q, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if not isinstance(kv_len, DTensor):
        kv_len = DTensor.from_local(kv_len, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    k = k.redistribute(mesh, kvp)
    v = v.redistribute(mesh, kvp)
    q = q.redistribute(mesh, qp)
    kv_len = kv_len.redistribute(mesh, lp)
    k_loc, v_loc = k.to_local(), v.to_local()
    if within is not None:
        dim, per_rank = within
        head = mesh.get_local_rank(dim) * per_rank // group
        k_loc, v_loc = k_loc.narrow(1, head, 1), v_loc.narrow(1, head, 1)
    out = decode(q.to_local(), k_loc, v_loc, kv_len.to_local(),
                 sm_scale=sm_scale, window=window, impl=impl)
    return DTensor.from_local(out, mesh, qp, run_check=False,
                              shape=q.shape, stride=q.stride())

"""Public wrapper for flash-decode (inference only: no gradient).

On an SPMD rank q, the cache and ``kv_len`` may arrive as DTensors (a
decode over a cache placed by ``launch.sharding.cache_shardings``).
:func:`decode` then follows the cache's placements, so the cache never
moves:

  * where the cache splits the batch or the kv heads over a mesh dim, q
    (and ``kv_len`` for the batch) split the same way;
  * where it splits the sequence (the sequence-parallel ``long_500k``
    cells, ``kv_seq_model``), each rank attends its own key shard, its
    live length taken in the shard's coordinates;
  * where the mesh dim that the JAX package's rules give the heads
    ("model"; on a mesh with no such dim, the first dim the cache leaves
    free) has n ranks, cannot split the kv heads, and n is a multiple
    of them, each kv head's replica is shared by r = n / Hkv ranks and
    its group of g q heads is split between them
    (``models.common.replica_plan``): by d = gcd(g, r) over the q heads and by
    c = r / d over the keys, each rank narrowing its own replica of the
    cache.  With c = 1 (granite-8b: 32 q / 8 kv heads over 16 ranks) the
    ranks' q heads are a plain split of the heads;
  * elsewhere q is replicated: a batch dim that a batch of one leaves
    free ("pod" of ("pod", "data", "model"), or "data" where the keys do
    not split over it) repeats the heads' work, as in the JAX package.

Every rank runs the kernel on its own rows, heads and keys.  Key shards
merge by their log-sum-exp (the kernel's ``return_lse``,
:func:`merge_key_shards`): an all-reduce max of the (B, Hq)
log-sum-exps, then an all-reduce sum of each shard's weighted output
and weight, (B, Hq, D + 1), over the mesh dims that split the keys.
A windowed decode is not split over keys: the decoder's rolling local
caches decode with no window (``models/decoder.py``), so no windowed
cache reaches that route, and it raises.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .kernel import decode_attention
from .ref import decode_ref


def decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_len: torch.Tensor, *, sm_scale: Optional[float] = None,
           window: Optional[int] = None,
           impl: str = "pallas", return_lse: bool = False):
    """``impl="pallas"`` takes the kernel wrapper; any other impl the
    plain version, except on CUDA tensors, which always launch the
    kernel, and on fake tensors, which always trace it.  With
    ``return_lse`` (plain tensors only), (out, lse) as the kernel gives
    them."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor

    if isinstance(k, DTensor):
        return _decode_local(q, k, v, kv_len, sm_scale, window, impl)
    if impl == "pallas" or q.device.type == "cuda" \
            or isinstance(q, FakeTensor):
        return decode_attention(q, k, v, kv_len, sm_scale=sm_scale,
                                window=window, return_lse=return_lse)
    return decode_ref(q, k, v, kv_len, sm_scale=sm_scale, window=window,
                      return_lse=return_lse)


def _decode_local(q, k, v, kv_len, sm_scale, window, impl):
    """``decode`` on each rank's local rows, heads and keys of a DTensor
    cache; returns a DTensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ...models.common import heads_mesh_dim, replica_plan, shard_range

    mesh = k.device_mesh
    hq, hkv = q.shape[1], k.shape[1]
    group = hq // hkv
    heads_split = any(isinstance(pl, Shard) and pl.dim == 1
                      for pl in k.placements)
    heads_dim = heads_mesh_dim(mesh)
    kvp, qp, lp = [], [], []
    merge = []             # mesh dims whose ranks hold shards of the keys
    replica = None         # (mesh dim, replica_plan) of a shared kv head
    for i, pl in enumerate(k.placements):
        n = mesh.size(i)
        if isinstance(pl, Shard) and pl.dim in (0, 1, 2):
            kvp.append(pl)
            qp.append(Shard(pl.dim) if pl.dim < 2 else Replicate())
            lp.append(Shard(0) if pl.dim == 0 else Replicate())
            if pl.dim == 2:
                merge.append(i)
            continue
        kvp.append(Replicate())
        lp.append(Replicate())
        plan = None if heads_split or replica is not None \
            or heads_dim not in (None, i) else replica_plan(hkv, group, n)
        if plan is None or plan[0] == 1:
            qp.append(Replicate())
            continue
        replica = (i, plan)
        # c = 1: the ranks' q heads are a plain split of the heads
        qp.append(Shard(1) if plan[2] == 1 else Replicate())
        if plan[2] > 1:
            merge.append(i)
    if merge and window is not None:
        raise ValueError("a windowed decode over a cache split along its "
                         "keys is not supported")
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
    q_loc, k_loc, v_loc = q.to_local(), k.to_local(), v.to_local()
    heads = slice(0, q_loc.shape[1])      # the rank's q heads of q_loc
    begin = shard_range(k, 2)[0]
    len_loc = kv_len.to_local()
    if replica is not None:
        dim, (r, d, c) = replica
        j = mesh.get_local_rank(dim)
        head = j // r
        k_loc, v_loc = k_loc.narrow(1, head, 1), v_loc.narrow(1, head, 1)
        if c > 1:
            per = group // d
            start = head * group + (j % r) // c * per
            heads = slice(start, start + per)
            # the rank's share of the local slots, [lo, hi)
            slots = k_loc.shape[2]
            if slots < c:
                raise ValueError(f"{slots} cache slots a rank cannot split "
                                 f"over {c} ranks")
            lo, hi = j % c * slots // c, (j % c + 1) * slots // c
            k_loc, v_loc = k_loc.narrow(2, lo, hi - lo), \
                v_loc.narrow(2, lo, hi - lo)
            begin += lo
    if not merge:
        out = decode(q_loc, k_loc, v_loc, len_loc, sm_scale=sm_scale,
                     window=window, impl=impl)
        return DTensor.from_local(out, mesh, qp, run_check=False,
                                  shape=q.shape, stride=q.stride())
    len_loc = (len_loc.long() - begin).clamp(0, k_loc.shape[2])
    out, lse = decode(q_loc[:, heads], k_loc, v_loc, len_loc,
                      sm_scale=sm_scale, impl=impl, return_lse=True)
    # the rank's heads in full-width rows: other heads add -inf and zeros
    b, n_heads = q_loc.shape[:2]
    whole_out = out.new_zeros((b, n_heads, out.shape[2]))
    whole_lse = lse.new_full((b, n_heads), float("-inf"))
    whole_out[:, heads], whole_lse[:, heads] = out, lse

    def reduce(x, op):
        pls = [Partial(op) if i in merge else pl for i, pl in enumerate(qp)]
        return DTensor.from_local(x, mesh, pls, run_check=False).redistribute(
            mesh, [Replicate() if i in merge else pl
                   for i, pl in enumerate(qp)]).to_local()

    out = merge_key_shards(whole_out, whole_lse, reduce)
    qp = [Replicate() if i in merge else pl for i, pl in enumerate(qp)]
    return DTensor.from_local(out.to(q.dtype), mesh, qp, run_check=False,
                              shape=q.shape, stride=q.stride())


def merge_key_shards(out: torch.Tensor, lse: torch.Tensor,
                     reduce: Callable) -> torch.Tensor:
    """Attention over every key shard from one shard's output ``out``
    (..., D) and log-sum-exp ``lse`` (...): the max of the log-sum-exps,
    then the sum of the outputs and weights exp(lse - max) they give;
    ``reduce(x, "max" | "sum")`` reduces ``x`` over the shards (an
    all-reduce over the mesh dims that split the keys, or a sum over a
    stacked dim).  A head no shard saw (every lse -inf) gets zeros.
    Returns f32."""
    top = reduce(lse, "max")
    w = torch.exp(lse - torch.where(torch.isfinite(top), top, 0.0))
    total = reduce(torch.cat([out.float() * w[..., None], w[..., None]],
                             dim=-1), "sum")
    return total[..., :-1] / torch.clamp(total[..., -1:], min=1e-30)

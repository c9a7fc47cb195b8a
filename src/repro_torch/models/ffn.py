"""FFN blocks: dense SwiGLU and Mixture-of-Experts.

MoE uses the JAX package's sort-based token dispatch: top-k routing,
a stable argsort of the (token, choice) entries by expert id, capacity-
bounded slots per expert (overflow drops to a dump slot), and batched
expert matmuls (E, C, d) x (E, d, f), so that FLOPs follow the active
parameters.  The combine puts each token's k contributions back in
(token, choice) order through the inverse permutation and sums over the
k choices in a fixed order in the compute dtype: no float atomics, so a
token's output does not depend on the order its entries were
dispatched in, and a run repeats bit for bit on the card.  Every move
between (token, choice) order, sorted-entry order and expert slots is a
gather or a scatter with unique indices whose backward is again one of
the two (:class:`_Permute`, :class:`_TokenEntries`,
:class:`_FromSlots`): no backward accumulates into a scatter, and a
token's k gradient terms are summed in choice order too.  Shared
experts (DeepSeek) are a fused dense SwiGLU of width
n_shared * d_ff_expert.  Plain torch: no Pallas kernel computes the
MoE in the JAX package either.

On DTensors (an SPMD rank, the dry run) :func:`moe_forward` routes as
on one device and then steps out of DTensor: each rank keeps the entries
of its own rows that go to its expert group, feeds the group's experts
by an all-to-all of entries or a reduce-scatter of the group's capacity
(:func:`_routed_on_ranks`), and each row's k contributions are summed
in choice order on one rank of the model axis; the JAX package's
partitioner makes the same crossing an all-to-all.  Under
``activation_sharding(mesh, moe_ep=(token_axes, model_axis))``,
:func:`ffn_forward` takes the expert-parallel :func:`moe_forward_ep`
instead: each rank runs its E/m experts on its own tokens with a
capacity counted from them, and one all-reduce over the model axis sums
the partial outputs.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from .common import (ParamSpec, _contiguous_stride, _is_dtensor, _placed,
                     _ready, copy_to_model, gathered_on_use,
                     model_rows_product, row_parallel, shard_range)
from .config import ArchConfig


@functools.cache
def _register_searchsorted_sharding() -> None:
    """Gives DTensor, which has none, a sharding strategy for
    ``aten.searchsorted.Tensor``, once: a 1-D sorted sequence is
    replicated and the values keep their own placement.  Routing a
    DTensor of router logits (an SPMD rank, the dry run) needs it."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.searchsorted.Tensor)
    def _strategy(sorted_sequence, values, *args, **kwargs):
        rep = Replicate()
        out = [([rep], [rep, rep])]
        if sorted_sequence.ndim == 1:
            out += [([Shard(d)], [rep, Shard(d)])
                    for d in range(values.ndim)]
        return out


def dense_specs(cfg: ArchConfig, d_ff: int | None = None
                ) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w1": ParamSpec((d, f), ("embed", "ffn"), "lecun"),
        "w3": ParamSpec((d, f), ("embed", "ffn"), "lecun"),
        "w2": ParamSpec((f, d), ("ffn", "embed"), "lecun"),
    }


def dense_forward(p, x: torch.Tensor, dtype) -> torch.Tensor:
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return row_parallel(h, p["w2"])


def moe_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    specs: Dict = {
        "router": ParamSpec((d, e), ("embed", None), "lecun"),
        "w1": ParamSpec((e, d, fe), ("experts", "embed", "ffn"), "lecun"),
        "w3": ParamSpec((e, d, fe), ("experts", "embed", "ffn"), "lecun"),
        "w2": ParamSpec((e, fe, d), ("experts", "ffn", "embed"), "lecun"),
    }
    if cfg.n_shared_experts:
        specs["shared"] = dense_specs(cfg, cfg.n_shared_experts
                                      * cfg.d_ff_expert)
    return specs


class Routing(NamedTuple):
    """Where each (token, choice) entry of a batch goes.  Entries are
    flattened token-major (entry = token * k + choice); ``order`` sorts
    them stably by expert id, and the ``sorted_*`` / ``keep`` / ``slot``
    fields are in that sorted order."""
    top_idx: torch.Tensor      # (S, k) expert ids, by falling gate
    top_vals: torch.Tensor     # (S, k) f32 gates, renormalized
    capacity: int              # slots per expert
    order: torch.Tensor        # (S*k,) entry at each sorted position
    sorted_tok: torch.Tensor   # (S*k,) token of each sorted entry
    keep: torch.Tensor         # (S*k,) bool: within its expert's capacity
    slot: torch.Tensor         # (S*k,) expert * capacity + rank, or the
    #                            dump slot E * capacity when dropped


def _gate_topk(logits: torch.Tensor, k: int):
    """``torch.topk(torch.softmax(logits, -1), k, -1)`` of (S, E) logits,
    computed on each rank's own rows when ``logits`` is a DTensor.

    torch registers ``aten.topk.default``'s DTensor strategy
    (``torch.distributed.tensor._ops._math_ops.topk_strategy``) with
    ``RuntimeSchemaInfo(2)``: its sharding cache keys a call by the
    arguments from index 2 on, so k (index 1) is not in the key, and a
    second call on logits of the same shape and placements with another
    k read the first one's output shape (torch 2.13 and 2.11).  So no
    DTensor op sees k: :class:`_LocalGateTopK` runs the softmax and the
    topk on the local rows, whether or not a torch version keys k."""
    if not _is_dtensor(logits):
        return torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    return _LocalGateTopK.apply(logits, k)


class _LocalGateTopK(torch.autograd.Function):
    """The forward places the logits as DTensor's softmax places them
    (the expert dim whole, any ``Partial`` summed: the same collectives),
    takes the softmax and the topk of the local tensor, and gives the
    gates and indices back as DTensors placed as the logits' rows are,
    with their global shape (S, k) set here.  The backward is torch's
    own for the two ops (``topk``'s scatter into zeros, then
    ``_softmax_backward_data``), on DTensors: DTensor places the
    gradient as it did when it ran the forward ops itself."""

    @staticmethod
    def forward(ctx, logits, k):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh, last = logits.device_mesh, logits.ndim - 1
        placements = tuple(
            Replicate() if pl.is_partial() or isinstance(pl, Shard)
            and pl.dim % logits.ndim == last else pl
            for pl in logits.placements)
        if placements != tuple(logits.placements):
            logits = logits.redistribute(mesh, placements)
        gates = torch.softmax(logits.to_local(), dim=-1)
        vals, idx = torch.topk(gates, k, dim=-1)
        s, e = logits.shape

        def wrap(t, width):
            return DTensor.from_local(t, mesh, placements, run_check=False,
                                      shape=(s, width), stride=(width, 1))

        gates, vals, idx = wrap(gates, e), wrap(vals, k), wrap(idx, k)
        ctx.save_for_backward(gates, idx)
        ctx.mark_non_differentiable(idx)
        # no zeros are made for the indices' (absent) gradient
        ctx.set_materialize_grads(False)
        return vals, idx

    @staticmethod
    def backward(ctx, g_vals, _):
        if g_vals is None:
            return None, None
        gates, idx = ctx.saved_tensors
        g = g_vals.new_zeros(gates.shape).scatter(-1, idx, g_vals)
        return torch._softmax_backward_data(g, gates, -1,
                                            gates.dtype), None


def route(cfg: ArchConfig, logits: torch.Tensor) -> Routing:
    """Top-k routing and capacity-bounded slots from router logits
    (S, E), exactly as the JAX package's ``moe_forward``."""
    s = logits.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    if _is_dtensor(logits):
        _register_searchsorted_sharding()
    top_vals, top_idx = _gate_topk(logits.float(), k)      # (S, k)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)
    # per-expert slots, clamped to S (one expert never receives more
    # than every token); capacity_factor >= E / k is dropless
    capacity = min(s, int((s * k / e) * cfg.capacity_factor) + 1)
    dev = logits.device
    flat_e = top_idx.reshape(s * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = order // k
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev, dtype=sorted_e.dtype),
        side="left")
    rank = torch.arange(s * k, device=dev) - seg_start[sorted_e]
    keep = rank < capacity                                 # overflow drops
    slot = torch.where(keep, sorted_e * capacity + rank,
                       torch.full_like(rank, e * capacity))
    return Routing(top_idx, top_vals, capacity, order, sorted_tok, keep,
                   slot)


def _choice_sum(per_entry: torch.Tensor, k: int) -> torch.Tensor:
    """(S * k, d) rows in (token, choice) order summed over each token's
    k choices, in choice order."""
    per_entry = per_entry.reshape(per_entry.shape[0] // k, k,
                                  *per_entry.shape[1:])
    out = per_entry[:, 0]
    for j in range(1, k):
        out = out + per_entry[:, j]
    return out


class _Permute(torch.autograd.Function):
    """``t[idx]`` for a permutation ``idx`` of ``t``'s rows whose inverse
    is ``inv``.  The backward is the gather ``g[inv]``, where autograd's
    own would scatter into zeros with an accumulating ``index_put``, an
    op the card's DTensor (torch 2.11) places with its values split by
    rows and its indices whole (ROADMAP C10)."""

    @staticmethod
    def forward(ctx, t, idx, inv):
        ctx.save_for_backward(inv)
        return t[idx]

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        return g[inv], None, None


class _TokenEntries(torch.autograd.Function):
    """``xf[sorted_tok]``: each token's row once for each of its k
    choices, in sorted-entry order (``sorted_tok = order // k``).  The
    backward puts the entries' gradient back in (token, choice) order
    with the inverse permutation ``inv`` and sums each token's k terms
    in choice order, as :func:`combine` sums its outputs."""

    @staticmethod
    def forward(ctx, xf, sorted_tok, inv, k):
        ctx.save_for_backward(inv)
        ctx.k = k
        return xf[sorted_tok]

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        return _choice_sum(g[inv], ctx.k), None, None, None


class _FromSlots(torch.autograd.Function):
    """The (E * C, d) expert rows read back at each sorted entry's slot
    and weighed by ``keep``: a dropped entry (slot E * C) reads the last
    slot, clamped, and keeps none of it.  The backward is the dispatch's
    scatter, at the unclamped slots: each kept entry's gradient lands in
    its own slot and a dropped one's (zero) in a dump row that is cut
    off, so nothing accumulates."""

    @staticmethod
    def forward(ctx, rows, slot, keep):
        ctx.save_for_backward(slot, keep)
        ctx.n = rows.shape[0]
        return rows[torch.clamp(slot, max=ctx.n - 1)] * keep

    @staticmethod
    def backward(ctx, g):
        slot, keep = ctx.saved_tensors
        out = g.new_zeros((ctx.n + 1, g.shape[1])).index_put((slot,),
                                                             g * keep)
        return out[:-1], None, None


def combine(contrib: torch.Tensor, order: torch.Tensor, s: int, k: int,
            inv: torch.Tensor | None = None) -> torch.Tensor:
    """Sum each token's k contributions, given in sorted-entry order
    (``contrib[j]`` belongs to entry ``order[j]``): the inverse
    permutation ``inv`` (``argsort(order)``, computed when not given)
    puts them back in (token, choice) order and the k terms are added in
    choice order.  The result does not depend on the dispatch order."""
    if inv is None:
        inv = torch.argsort(order)
    return _choice_sum(_Permute.apply(contrib, inv, order), k)


def moe_forward(p, x: torch.Tensor, cfg: ArchConfig, dtype,
                decode: bool = False) -> torch.Tensor:
    """``decode``: a decode step's stream (no gradient), whose router
    product each "model" rank takes its share of
    (:func:`~.common.model_rows_product`)."""
    b, t, d = x.shape
    s = b * t
    # the flattened tokens feed the router, the experts and the shared
    # expert; their gradient is placed as they are, split along the
    # tokens as the rows were (256 rows do not split over a 512-rank
    # flattening)
    xf = copy_to_model(x.reshape(s, d))
    r = route(cfg, model_rows_product(xf, p["router"]) if decode
              else xf @ p["router"])
    if _is_dtensor(xf):
        xf = _token_rows(xf, p["w1"])
    routed = _routed_on_ranks if _is_dtensor(xf) else _routed
    out = routed(p, xf, r, cfg, dtype)
    if cfg.n_shared_experts:
        # in training FSDP's split of the shared expert's d is gathered
        # on use: left to itself, DTensor may gather the rows instead
        shared = {n: gathered_on_use(p["shared"][n])
                  for n in ("w1", "w3", "w2")}
        out = out + dense_forward(shared, xf, dtype)
    return out.reshape(b, t, d)


def _token_rows(xf: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """DTensor rows ``xf`` (S, d) split by rows over the mesh dims that
    split them by rows or by d and do not split the experts (the token
    dims), and whole over every other: what the routed experts take."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = xf.device_mesh
    return _placed(xf, mesh, [
        Shard(0) if isinstance(pl, Shard) and not (
            isinstance(w, Shard) and w.dim != 1) else Replicate()
        for pl, w in zip(xf.placements, w1.placements)])


def _routed(p, xf: torch.Tensor, r: Routing, cfg: ArchConfig, dtype
            ) -> torch.Tensor:
    """The routed experts' output for one device's (S, d) rows."""
    s, d = xf.shape
    e, k, cap = cfg.n_experts, cfg.top_k, r.capacity
    keep = r.keep[:, None].to(dtype)
    # token -> slot scatter; every dropped entry lands, zeroed, in the
    # dump row E * capacity, which is cut off
    inv = torch.argsort(r.order)
    buf = xf.new_zeros((e * cap + 1, d), dtype=dtype).index_put(
        (r.slot,), _TokenEntries.apply(xf, r.sorted_tok, inv, k) * keep)
    expert_in = buf[:-1].reshape(e, cap, d)
    h = F.silu(torch.bmm(expert_in, p["w1"])) * \
        torch.bmm(expert_in, p["w3"])
    out_e = torch.bmm(h, p["w2"]).reshape(e * cap, d)
    gathered = _FromSlots.apply(out_e, r.slot, keep)
    gates = _Permute.apply(r.top_vals.reshape(s * k), r.order, inv)
    return combine(gathered * gates[:, None].to(dtype), r.order, s, k, inv)


# ---------------------------------------------------------------------------
# the routed experts on an SPMD rank
# ---------------------------------------------------------------------------
# On DTensors the step's rows (S, d) stay split over the mesh dims that
# split them (the token dims: "data", or "pod" and "data") and whole over
# "model"; the expert weights are split over "model" by experts (or by
# their ffn dim where the experts do not divide), and FSDP splits their
# d over "data".  Rank (i, j) (i on the token dims, j on "model") holds
# its rows and every entry's global slot (the route is replicated), and
# keeps the entries of its own rows that go to its expert group j.  A
# reduce-scatter over "model" then hands each rank all k contributions
# of its share of the rows (each lies on one group's rank), summed in
# choice order as on one device, and an all-gather joins the rows.  No
# rank holds the step's rows or every expert's output.  (The rows are
# first placed so: :func:`_token_rows`.)  Two ways to feed
# the group's experts, chosen by the bytes each moves
# (:func:`feed_bytes`):
#
#   * slot blocks: the group's capacity rows are split over the token
#     dims, each rank multiplying its block by the group's weights whole
#     (gathered over FSDP's dims on use, their gradient reduce-scattered
#     back); each entry goes to the rank of its slot and comes back
#     through an all-to-all over the token dims whose split sizes are
#     read from the route.  The weights move, the tokens barely: the
#     prefill and training steps of a pod;
#   * embed blocks: every rank of the group takes all of its capacity
#     rows but only the d columns of its FSDP block (a reduce-scatter of
#     the entries over the token dims), multiplies them by its block of
#     the weights, sums the partial products over FSDP's dims (in f32 in
#     training, as one device rounds its f32 sum once) and gathers the
#     output's columns back.  The weights stay, the group's capacity
#     moves: decode, and steps of a few thousand rows.
def _routed_on_ranks(p, xf, r: Routing, cfg: ArchConfig, dtype):
    """The routed experts' output of DTensor rows ``xf`` (S, d), placed
    as ``xf`` is: the forward of :func:`_routed` on an SPMD rank, the
    same route, the same kept entries in the same slots."""
    from torch.distributed.tensor import Partial, Shard

    mesh, w1 = xf.device_mesh, p["w1"]
    s, d = xf.shape
    k, cap = cfg.top_k, r.capacity
    tok = [i for i, pl in enumerate(xf.placements)
           if pl == Shard(0) and mesh.size(i) > 1]
    split = [i for i, pl in enumerate(w1.placements)
             if isinstance(pl, Shard) and pl.dim != 1 and mesh.size(i) > 1]
    fsdp = [i for i, pl in enumerate(w1.placements)
            if pl == Shard(1) and mesh.size(i) > 1]
    if set(split) & set(tok) or tok and split and max(tok) > min(split):
        raise ValueError(f"MoE rows split over mesh dims {tok}, experts "
                         f"over {split}: the rows' dims must come first")
    lo, n_e = shard_range(w1, 0)
    f_l = shard_range(w1, 2)[1]

    counts = [mesh.size(i) for i in tok]
    rows = _blocks(s, counts)
    f = 0
    for i in tok:
        f = f * mesh.size(i) + mesh.get_local_rank(i)
    t0, s_l = rows[f]
    order, slot, keep = (_whole(t) for t in (r.order, r.slot, r.keep))
    own = torch.argsort(order)[t0 * k:(t0 + s_l) * k]
    slot_o = slot[own]
    ex = slot_o // cap
    row = slot_o - ex * cap
    mine = keep[own] & (ex >= lo) & (ex < lo + n_e)

    # the rows and gates of the rank's own entries, (token, choice)
    # order; their gradient is the group's share: partial over "model"
    grad_pls = [Shard(0) if i in tok else Partial() if i in split else pl
                for i, pl in enumerate(xf.placements)]
    xl = xf.to_local(grad_placements=grad_pls).to(dtype)
    gates = _placed(r.top_vals, mesh, xf.placements).to_local(
        grad_placements=grad_pls).reshape(s_l * k)
    entries = xl if k == 1 else _TokenEntries.apply(
        xl, torch.arange(s_l * k, device=xl.device) // k,
        torch.arange(s_l * k, device=xl.device), k)

    grad = torch.is_grad_enabled() and w1.requires_grad
    if not fsdp or _by_slot_blocks(
            n_e, cap, d, f_l, w1.dtype.itemsize,
            math.prod(mesh.size(i) for i in tok),
            math.prod(mesh.size(i) for i in fsdp), grad):
        feed = _slot_blocks
    else:
        feed = _embed_blocks
    gathered = feed(p, entries, mesh, tok, fsdp, r, cfg.n_experts,
                    (lo, n_e, ex, row, mine), rows, f)
    return _RowSums.apply(gathered * gates[:, None].to(dtype), k, mesh,
                          tuple(split), (s, d), tuple(xf.placements))


def feed_bytes(n_e: int, cap: int, d: int, f_l: int, itemsize: int,
               n_tok: int, n_fsdp: int, grad: bool) -> tuple:
    """The collective bytes a rank of an expert group of ``n_e`` experts
    (capacity ``cap``, width ``d``, the rank's ``f_l`` of the ffn dim,
    weights of ``itemsize`` bytes) receives in one MoE layer when the
    group is fed by slot blocks and by embed blocks: each collective's
    result on the rank, as the dry run's counter books it, forward and,
    where a gradient is taken (``grad``), backward; the tokens split
    ``n_tok`` ways, FSDP's d ``n_fsdp`` ways, a balanced route.

    Slot blocks gather the group's three (n_e, d, f) weights whole and
    send the rank's share of the capacity rows, (n_e * C / n_tok, d),
    to their ranks and back; the backward reduce-scatters the weights'
    gradient and sends the rows' gradient both ways.  Embed blocks
    reduce-scatter the group's capacity rows (n_e * C, d) by d, sum two
    (n_e, C, f) partial products (f32 where a gradient is taken) and
    gather the output's d; the backward reduce-scatters the output's
    gradient, sums the product's and gathers the input's."""
    rows = n_e * cap * d * itemsize
    weights = 3 * n_e * d * f_l * itemsize
    partial = n_e * cap * f_l
    slot = weights + 2 * rows // n_tok
    embed = rows // n_fsdp + 2 * partial * (4 if grad else itemsize) + rows
    if grad:
        slot += weights // n_fsdp + 2 * rows // n_tok
        embed += rows // n_fsdp + partial * itemsize + rows
    return slot, embed


def _by_slot_blocks(*sizes) -> bool:
    """Whether slot blocks move fewer bytes than embed blocks
    (:func:`feed_bytes` of ``sizes``)."""
    slot, embed = feed_bytes(*sizes)
    return slot < embed


def _blocks(size: int, counts) -> list:
    """(first, length) of each rank's block of ``size`` rows split over
    mesh dims of ``counts`` ranks in turn (``torch.chunk``'s split, as
    DTensor nests it), in the ranks' row-major order."""
    out = [(0, size)]
    for n in counts:
        nxt = []
        for first, length in out:
            chunk = -(-length // n)
            for c in range(n):
                lo = min(c * chunk, length)
                nxt.append((first + lo, min(length - lo, chunk)))
        out = nxt
    return out


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value as a local tensor; ``t`` otherwise."""
    return t.full_tensor() if _is_dtensor(t) else t


def _embed_blocks(p, entries, mesh, tok, fsdp, r, e, where, *_):
    """Each rank's own entries' expert rows (zeros for the others), the
    group's capacity fed by embed blocks (see above)."""
    from torch.distributed.tensor import Partial, Shard

    lo, n_e, ex, row, mine = where
    cap, d = r.capacity, entries.shape[1]
    at = torch.where(mine, (ex - lo) * cap + row,
                     torch.full_like(row, n_e * cap))
    buf = entries.new_zeros((n_e * cap + 1, d)).index_put((at,), entries)
    summed = {i: Partial() for i in tok}
    cols = {i: Shard(1) for i in fsdp}
    partial = {i: Partial() for i in fsdp}
    ein = _Moved.apply(buf[:-1], mesh, (n_e * cap, d), (summed, cols),
                       (cols, {}))
    ein = ein.reshape(n_e, cap, -1)
    w1, w3, w2 = (p[n].to_local() for n in ("w1", "w3", "w2"))
    dtype = entries.dtype
    f32 = torch.is_grad_enabled() and p["w1"].requires_grad
    hs = []
    for w in (w1, w3):
        h = torch.bmm(ein.float(), w.float()) if f32 else torch.bmm(ein, w)
        hs.append(_Moved.apply(h, mesh, tuple(h.shape), (partial, {}),
                               ({}, {})).to(dtype))
    h = F.silu(hs[0]) * hs[1]
    h = _Moved.apply(h, mesh, tuple(h.shape), ({}, {}), (partial, {}))
    out_e = torch.bmm(h, w2).reshape(n_e * cap, -1)
    out_e = _Moved.apply(out_e, mesh, (n_e * cap, d), (cols, {}),
                         (summed, cols))
    return _FromSlots.apply(out_e, at, mine[:, None].to(dtype))


def _slot_blocks(p, entries, mesh, tok, fsdp, r, e, where, rows, f):
    """Each rank's own entries' expert rows (zeros for the others), the
    group's capacity fed by slot blocks (see above)."""
    from torch.distributed.tensor import Partial, Replicate

    lo, n_e, ex, row, mine = where
    n_t, d, cap = len(rows), entries.shape[1], r.capacity
    dev = entries.device
    caps = _blocks(cap, [mesh.size(i) for i in tok])
    first = torch.tensor([b for b, _ in caps], device=dev)
    length = torch.tensor([n for _, n in caps], device=dev)
    dst = torch.searchsorted(first, row, right=True) - 1
    # the entries sent, by destination: the group's kept ones
    order = torch.argsort(torch.where(mine, dst, n_t), stable=True)
    pairs = _pair_counts(r, e, lo, n_e, rows, caps)
    send, recv = pairs[f], [pairs[i][f] for i in range(n_t)]
    idx = order[:sum(send)]
    at = (ex[idx] - lo) * length[dst[idx]] + row[idx] - first[dst[idx]]
    group = _token_group(mesh, tok)
    sent = _Take.apply(entries, idx)
    got = _AllToAll.apply(sent, send, recv, group)
    at = _all_to_all(at, send, recv, group)
    n_l = caps[f][1]
    ein = got.new_zeros((n_e * n_l, d)).index_put((at,), got)
    ein = ein.reshape(n_e, n_l, d)

    def whole(w):
        pls = [Replicate() if i in fsdp else pl
               for i, pl in enumerate(w.placements)]
        return _LocalBlock.apply(w, tuple(pls), tuple(
            Partial() if i in tok else pl for i, pl in enumerate(pls)))

    w1, w3, w2 = (whole(p[n]) for n in ("w1", "w3", "w2"))
    h = F.silu(torch.bmm(ein, w1)) * torch.bmm(ein, w3)
    out_e = torch.bmm(h, w2).reshape(n_e * n_l, d)
    back = _AllToAll.apply(_Take.apply(out_e, at), recv, send, group)
    return back.new_zeros((entries.shape[0], d)).index_put((idx,), back)


def _pair_counts(r: Routing, e: int, lo: int, n_e: int, rows, caps
                 ) -> list:
    """``out[i][j]``: how many of the group's kept entries the rank of
    token block i sends to the rank of slot block j, read from the
    route (one read back to the host)."""
    slot, cap = _whole(r.slot), r.capacity
    n_t = len(rows)
    dev = slot.device
    ex = slot // cap
    mask = _whole(r.keep) & (ex >= lo) & (ex < lo + n_e)
    src = torch.searchsorted(torch.tensor([b for b, _ in rows], device=dev),
                             _whole(r.sorted_tok), right=True) - 1
    dst = torch.searchsorted(torch.tensor([b for b, _ in caps], device=dev),
                             slot - ex * cap, right=True) - 1
    key = torch.where(mask, src * n_t + dst, n_t * n_t)
    return torch.bincount(key, minlength=n_t * n_t + 1)[:-1].view(
        n_t, n_t).tolist()


def _token_group(mesh, tok):
    """The group of the token dims ``tok`` for a functional collective
    (the flattened sub-mesh where there are two); None where no mesh dim
    splits the tokens."""
    if not tok:
        return None
    if len(tok) == 1:
        return (mesh, tok[0])
    names = mesh.mesh_dim_names
    return (mesh[tuple(names[i] for i in tok)]._flatten(), 0)


def _all_to_all(t: torch.Tensor, send, recv, group) -> torch.Tensor:
    """``send[j]`` rows of ``t`` to rank j of ``group``, in rank order;
    the result holds ``recv[i]`` rows from rank i, in rank order."""
    if group is None:
        return t
    from torch.distributed import _functional_collectives as funcol

    return _ready(funcol.all_to_all_single(t.contiguous(), list(recv),
                                           list(send), group))


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all` of rows; the backward sends each row's
    gradient back to the rank the row came from."""

    @staticmethod
    def forward(ctx, t, send, recv, group):
        ctx.back = (recv, send, group)
        return _all_to_all(t, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.back), None, None, None


class _Take(torch.autograd.Function):
    """``t[idx]`` for unique indices ``idx``; the backward puts each
    row's gradient back in its own row, with no accumulation."""

    @staticmethod
    def forward(ctx, t, idx):
        ctx.save_for_backward(idx)
        ctx.n = t.shape[0]
        return t[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return g.new_zeros((ctx.n,) + tuple(g.shape[1:])).index_put(
            (idx,), g), None


def _move(t: torch.Tensor, mesh, shape, src: dict, dst: dict
          ) -> torch.Tensor:
    """Local tensor ``t`` placed on ``mesh`` as ``src`` says (mesh dim
    -> placement, Replicate on every other dim), of global ``shape``,
    redistributed to ``dst``: the rank's local result."""
    from torch.distributed.tensor import DTensor, Replicate

    if src == dst:
        return t
    pls = [src.get(i, Replicate()) for i in range(mesh.ndim)]
    whole = DTensor.from_local(t.contiguous(), mesh, pls, run_check=False,
                               shape=tuple(shape),
                               stride=_contiguous_stride(shape))
    return _ready(whole.redistribute(mesh, [
        dst.get(i, Replicate()) for i in range(mesh.ndim)]).to_local())


class _Moved(torch.autograd.Function):
    """:func:`_move` of a local tensor of global ``shape`` from
    ``fwd[0]`` to ``fwd[1]``, and of its gradient from ``bwd[0]`` to
    ``bwd[1]``.  The caller names both
    pairs: only it knows where a rank's values or gradient are partial
    sums."""

    @staticmethod
    def forward(ctx, t, mesh, shape, fwd, bwd):
        ctx.args = (mesh, shape) + tuple(bwd)
        return _move(t, mesh, shape, *fwd)

    @staticmethod
    def backward(ctx, g):
        return _move(g, *ctx.args), None, None, None, None


class _LocalBlock(torch.autograd.Function):
    """The rank's block of DTensor ``w`` placed as ``pls``.  The
    backward takes the block's gradient as placed by ``grad_pls`` (a
    partial sum where the rank multiplied only its rows) and hands it
    back placed as ``w`` is."""

    @staticmethod
    def forward(ctx, w, pls, grad_pls):
        ctx.w = (w.device_mesh, tuple(w.placements), w.shape, w.stride())
        ctx.grad_pls = grad_pls
        return _ready(_placed(w, w.device_mesh, pls).to_local())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        mesh, pls, shape, stride = ctx.w
        out = DTensor.from_local(g.contiguous(), mesh, ctx.grad_pls,
                                 run_check=False, shape=shape, stride=stride)
        return _placed(out, mesh, pls), None, None


class _RowSums(torch.autograd.Function):
    """The rank's rows' k contributions (S_l * k, d), in (token, choice)
    order, summed in choice order into a DTensor of global ``shape``
    placed as ``pls``.  An entry's contribution lies on the rank of its
    expert's group alone (zeros elsewhere), so a reduce-scatter over the
    ``split`` mesh dims by rows hands each rank all k contributions of
    its share of the rows, exact; it sums them as one device sums them,
    and an all-gather joins the rows.  Each contribution's gradient is
    its row's, which every rank of the ``split`` dims holds: the
    backward moves nothing."""

    @staticmethod
    def forward(ctx, contrib, k, mesh, split, shape, pls):
        from torch.distributed.tensor import DTensor, Partial, Shard

        ctx.k, ctx.mesh, ctx.pls = k, mesh, pls
        s_l, d = contrib.shape[0] // k, contrib.shape[1]
        by_rows = {i: Shard(0) for i in split}
        rows = _move(contrib.reshape(s_l, k, d), mesh, (s_l, k, d),
                     {i: Partial() for i in split}, by_rows)
        out = _choice_sum(rows.reshape(-1, d), k)
        whole = DTensor.from_local(
            out, mesh, [by_rows.get(i, pl) for i, pl in enumerate(pls)],
            run_check=False, shape=shape, stride=_contiguous_stride(shape))
        return _placed(whole, mesh, pls)

    @staticmethod
    def backward(ctx, g):
        g = _ready(_placed(g, ctx.mesh, ctx.pls).to_local())
        return (g.repeat_interleave(ctx.k, dim=0), None, None, None, None,
                None)


def _local(t: torch.Tensor, mesh_dims: Dict[str, int]):
    """The rank's local tensor of DTensor ``t`` with its dim 0 sharded
    over the mesh dims ``mesh_dims`` names (and every other dim
    gathered), or ``t`` itself when it is a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    # a mesh dim of size 1 keeps its placement (nothing to move)
    want = tuple(t.placements[i] if mesh.size(i) == 1
                 else Shard(0) if names[i] in mesh_dims else Replicate()
                 for i in range(mesh.ndim))
    return t.redistribute(mesh, want).to_local()


def moe_forward_ep(p, x: torch.Tensor, cfg: ArchConfig, dtype,
                   mesh, token_axes, model_axis: str) -> torch.Tensor:
    """Expert-parallel MoE (the JAX package's ``shard_map`` path).

    Tokens stay batch-sharded over ``token_axes`` (replicated across
    the model axis); experts are split over ``model_axis``.  Routing and
    top-k are computed for each rank's tokens exactly as
    :func:`moe_forward` routes them; the dispatch, the expert products
    and the combine are shard-local, and the only collective is one
    all-reduce of the (S_local, d) partial outputs over the model axis
    (a DTensor ``Partial`` made ``Replicate``).  The combine keeps the
    fixed order of terms: each rank sums its own entries' k choices in
    choice order (foreign entries contribute zeros).  The capacity is
    counted from the rank's S_local tokens, as in the JAX package.
    ``x`` is a DTensor (B sharded over ``token_axes`` where it divides)
    on the rank's DeviceMesh, and so are the weights.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    token_axes = (token_axes,) if isinstance(token_axes, str) \
        else tuple(token_axes)
    if not isinstance(x, DTensor):
        raise TypeError("moe_forward_ep runs on an SPMD rank's DTensors")
    dmesh = x.device_mesh
    names = dmesh.mesh_dim_names
    m = dmesh.size(names.index(model_axis))
    e, k = cfg.n_experts, cfg.top_k
    assert e % m == 0, (e, m)
    e_loc = e // m
    j = dmesh.get_local_rank(model_axis)
    lo = j * e_loc

    n_tok = 1
    for a in token_axes:
        n_tok *= dmesh.size(names.index(a))
    split = x.shape[0] % n_tok == 0 and x.shape[0] > 1
    x_l = _local(x, {a: 1 for a in token_axes} if split else {})
    b_l, t, d = x_l.shape
    s_l = b_l * t
    xf = x_l.reshape(s_l, d)
    r = route(cfg, xf @ _local(p["router"], {}).to(dtype))
    w1, w3, w2 = (_local(p[n], {model_axis: 1}).to(dtype)
                  for n in ("w1", "w3", "w2"))

    # this rank's experts: foreign entries sort last (id e_loc) and drop
    flat_e = r.top_idx.reshape(s_l * k)
    mine = (flat_e >= lo) & (flat_e < lo + e_loc)
    local_e = torch.where(mine, flat_e - lo, torch.full_like(flat_e, e_loc))
    order = torch.argsort(local_e, stable=True)
    se = local_e[order]
    st = order // k
    seg = torch.searchsorted(
        se, torch.arange(e_loc + 1, device=xf.device, dtype=se.dtype),
        side="left")
    rank = torch.arange(s_l * k, device=xf.device) - seg[
        torch.clamp(se, max=e_loc)]
    keep = (se < e_loc) & (rank < r.capacity)
    cap = r.capacity
    slot = torch.where(keep, se * cap + rank,
                       torch.full_like(rank, e_loc * cap))
    keep_f = keep[:, None].to(dtype)
    buf = torch.zeros((e_loc * cap + 1, d), dtype=dtype, device=xf.device)
    buf[slot] = xf[st] * keep_f
    ein = buf[:-1].reshape(e_loc, cap, d)
    h = F.silu(torch.bmm(ein, w1)) * torch.bmm(ein, w3)
    oe = torch.bmm(h, w2).reshape(e_loc * cap, d)
    g = oe[torch.clamp(slot, max=e_loc * cap - 1)] * keep_f
    contrib = g * r.top_vals.reshape(s_l * k)[order][:, None].to(dtype)
    out_l = combine(contrib, order, s_l, k)

    token_dims = [names.index(a) for a in token_axes] if split else []
    partial = tuple(Shard(0) if i in token_dims
                    else Partial() if names[i] == model_axis
                    else Replicate() for i in range(dmesh.ndim))
    out = DTensor.from_local(out_l.reshape(b_l, t, d), dmesh, partial,
                             run_check=False)
    out = out.redistribute(dmesh, tuple(
        Replicate() if isinstance(pl, Partial) else pl for pl in partial))
    if cfg.n_shared_experts:
        b = x.shape[0]
        shared = dense_forward(p["shared"], x.reshape(b * t, d), dtype)
        out = out + shared.reshape(b, t, d)
    return out


def ffn_specs(cfg: ArchConfig, kind: str) -> Dict[str, ParamSpec]:
    return moe_specs(cfg) if kind == "moe" else dense_specs(cfg)


def ffn_forward(p, x: torch.Tensor, cfg: ArchConfig, kind: str, dtype,
                decode: bool = False) -> torch.Tensor:
    if kind == "moe":
        from .common import _ACT_CTX

        ctx = _ACT_CTX.get()
        if ctx is not None and ctx["axes"].get("moe_ep"):
            token_axes, model_axis = ctx["axes"]["moe_ep"]
            return moe_forward_ep(p, x, cfg, dtype, ctx["mesh"],
                                  token_axes, model_axis)
        return moe_forward(p, x, cfg, dtype, decode)
    return dense_forward(p, x, dtype)

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

On an SPMD rank, under ``activation_sharding(mesh, moe_ep=(token_axes,
model_axis))``, :func:`ffn_forward` takes the expert-parallel
:func:`moe_forward_ep`: each rank runs its E/m experts on its own
tokens and one all-reduce over the model axis sums the partial outputs.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from .common import ParamSpec, _is_dtensor, copy_to_model, row_parallel
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
    per_entry = per_entry.reshape(per_entry.shape[0] // k, k, -1)
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


def _whole_capacity(t: torch.Tensor) -> torch.Tensor:
    """``t`` of (E, C, d), and its gradient, with the capacity dim
    gathered where a DTensor splits it; anything else as it is.  DTensor
    flattens a split inner dim into a strided shard, whose row offsets
    it computes from a tensor that a fake tensor cannot read; the
    (E, C, d) <-> (E * C, d) slot reshapes (and their gradients) would
    hit that."""
    return _WholeCapacity.apply(t) if _is_dtensor(t) else t


def _gather_dim1(t):
    from torch.distributed.tensor import Replicate, Shard

    pls = [Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
           for pl in t.placements]
    return t if pls == list(t.placements) else \
        t.redistribute(t.device_mesh, pls)


class _WholeCapacity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _gather_dim1(t)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim1(g)


def _expert_product(x: torch.Tensor, w: torch.Tensor, dtype
                    ) -> torch.Tensor:
    """``torch.bmm(x, w)`` of (E, C, d) rows and (E, d, f) weights.
    In training, where a mesh dim splits a DTensor weight's contraction
    dim d (FSDP's "embed" over "data"), the product is taken in f32, so
    that its partial sums are summed in f32 and rounded once to
    ``dtype``, as one device's product sums its whole contraction in f32
    and rounds once: partials rounded to bf16 apiece put deepseek-v2's
    MoE output on a (2, 2) mesh 3 bf16 ulps off one device's (an H100,
    published widths).  The partial sums are reduce-scattered over f,
    where DTensor places a bf16 product's, so that what follows is
    placed as it would be.  Forward-only routes (prefill, decode) keep
    the bf16 product: an f32 copy of the weights a step would cost a
    decode step more than its few rows gain."""
    if not (_is_dtensor(w) and w.requires_grad
            and torch.is_grad_enabled() and any(
            pl.is_shard(1) and w.device_mesh.size(i) > 1
            for i, pl in enumerate(w.placements))):
        return torch.bmm(x, w)
    from torch.distributed.tensor import Shard

    out = torch.bmm(x.float(), w.float())
    out = out.redistribute(out.device_mesh, [
        Shard(2) if pl.is_partial() else pl for pl in out.placements])
    return out.to(dtype)


def moe_forward(p, x: torch.Tensor, cfg: ArchConfig, dtype
                ) -> torch.Tensor:
    b, t, d = x.shape
    s = b * t
    e, k = cfg.n_experts, cfg.top_k
    # the flattened tokens feed the experts' products; their gradient is
    # placed as they are, split along the tokens as the rows were (256
    # rows do not split over a 512-rank flattening)
    xf = copy_to_model(x.reshape(s, d))
    r = route(cfg, xf @ p["router"])
    cap = r.capacity
    keep = r.keep[:, None].to(dtype)

    # token -> slot scatter; every dropped entry lands, zeroed, in the
    # dump row E * capacity, which is cut off.  Out of place: DTensor has
    # no strategy for the in-place index_put_ in some torch versions
    # (2.11), and places the out-of-place one in every version
    inv = torch.argsort(r.order)
    buf = xf.new_zeros((e * cap + 1, d), dtype=dtype).index_put(
        (r.slot,), _TokenEntries.apply(xf, r.sorted_tok, inv, k) * keep)
    expert_in = _whole_capacity(buf[:-1].reshape(e, cap, d))

    h = F.silu(_expert_product(expert_in, p["w1"], dtype)) * \
        _expert_product(expert_in, p["w3"], dtype)
    out_e = _whole_capacity(torch.bmm(h, p["w2"])).reshape(e * cap, d)

    gathered = _FromSlots.apply(out_e, r.slot, keep)
    gates = _Permute.apply(r.top_vals.reshape(s * k), r.order, inv)
    contrib = gathered * gates[:, None].to(dtype)
    out = combine(contrib, r.order, s, k, inv)
    if cfg.n_shared_experts:
        out = out + dense_forward(p["shared"], xf, dtype)
    return out.reshape(b, t, d)


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


def ffn_forward(p, x: torch.Tensor, cfg: ArchConfig, kind: str, dtype
                ) -> torch.Tensor:
    if kind == "moe":
        from .common import _ACT_CTX

        ctx = _ACT_CTX.get()
        if ctx is not None and ctx["axes"].get("moe_ep"):
            token_axes, model_axis = ctx["axes"]["moe_ep"]
            return moe_forward_ep(p, x, cfg, dtype, ctx["mesh"],
                                  token_axes, model_axis)
        return moe_forward(p, x, cfg, dtype)
    return dense_forward(p, x, dtype)

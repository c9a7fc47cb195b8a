"""FFN blocks: dense SwiGLU and Mixture-of-Experts.

MoE uses the JAX package's sort-based token dispatch: top-k routing,
a stable argsort of the (token, choice) entries by expert id, capacity-
bounded slots per expert (overflow drops to a dump slot), and batched
expert matmuls (E, C, d) x (E, d, f), so that FLOPs follow the active
parameters.  The combine puts each token's k contributions back in
(token, choice) order through the inverse permutation and sums over the
k choices in a fixed order in the compute dtype: no float atomics, so a
token's output does not depend on the order its entries were
dispatched in, and a run repeats bit for bit on the card.  Shared
experts (DeepSeek) are a fused dense SwiGLU of width
n_shared * d_ff_expert.  Plain torch: no Pallas kernel computes the
MoE in the JAX package either.  Its expert-parallel ``moe_forward_ep``
(``shard_map``) waits for the multi-device item, ROADMAP A6.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from .common import ParamSpec
from .config import ArchConfig


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
    return h @ p["w2"]


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


def route(cfg: ArchConfig, logits: torch.Tensor) -> Routing:
    """Top-k routing and capacity-bounded slots from router logits
    (S, E), exactly as the JAX package's ``moe_forward``."""
    s = logits.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    gates = torch.softmax(logits.float(), dim=-1)
    top_vals, top_idx = torch.topk(gates, k, dim=-1)       # (S, k)
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


def combine(contrib: torch.Tensor, order: torch.Tensor, s: int, k: int
            ) -> torch.Tensor:
    """Sum each token's k contributions, given in sorted-entry order
    (``contrib[j]`` belongs to entry ``order[j]``): the inverse
    permutation puts them back in (token, choice) order and the k terms
    are added in choice order.  The result does not depend on the
    dispatch order."""
    per_entry = contrib[torch.argsort(order)].reshape(s, k, -1)
    out = per_entry[:, 0]
    for j in range(1, k):
        out = out + per_entry[:, j]
    return out


def moe_forward(p, x: torch.Tensor, cfg: ArchConfig, dtype
                ) -> torch.Tensor:
    b, t, d = x.shape
    s = b * t
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(s, d)
    r = route(cfg, xf @ p["router"])
    cap = r.capacity
    keep = r.keep[:, None].to(dtype)

    # token -> slot scatter; every dropped entry lands, zeroed, in the
    # dump row E * capacity, which is cut off
    buf = torch.zeros((e * cap + 1, d), dtype=dtype, device=x.device)
    buf[r.slot] = xf[r.sorted_tok] * keep
    expert_in = buf[:-1].reshape(e, cap, d)

    h = F.silu(torch.bmm(expert_in, p["w1"])) * torch.bmm(expert_in,
                                                         p["w3"])
    out_e = torch.bmm(h, p["w2"]).reshape(e * cap, d)

    gathered = out_e[torch.clamp(r.slot, max=e * cap - 1)] * keep
    contrib = gathered * r.top_vals.reshape(s * k)[r.order][:, None].to(
        dtype)
    out = combine(contrib, r.order, s, k)
    if cfg.n_shared_experts:
        out = out + dense_forward(p["shared"], xf, dtype)
    return out.reshape(b, t, d)


def ffn_specs(cfg: ArchConfig, kind: str) -> Dict[str, ParamSpec]:
    return moe_specs(cfg) if kind == "moe" else dense_specs(cfg)


def ffn_forward(p, x: torch.Tensor, cfg: ArchConfig, kind: str, dtype
                ) -> torch.Tensor:
    if kind == "moe":
        return moe_forward(p, x, cfg, dtype)
    return dense_forward(p, x, dtype)

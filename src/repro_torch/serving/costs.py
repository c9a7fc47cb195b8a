"""Serving cost model: FLOPs-based CE pricing, device-bytes weights.

The knapsack weight of a cached prefix is the per-arch state footprint:

  * GQA layers       2 · H_kv · head_dim · len · dtype  per layer
  * local (window)   same, clipped at the window length
  * MLA              (kv_lora + rope) · len
  * Mamba / RG-LRU   O(1): conv window + recurrent state, len-free

The value follows Eq. 1–3 with C_E = prefill cost of the prefix
(2 · N_active · len linear term + the attention quadratic term),
C_W / C_R = write/read of the state bytes.  The weight is what the
state holds for ``len`` tokens, not the size of the tensors that carry
it: the engine keeps each state in a ``max_len`` cache.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..models.config import ArchConfig
from .request import TokenBlock

# Pricing units of the reference cost model: C_E is FLOPs / PRICE_FLOPS
# and C_W, C_R are bytes / PRICE_BYTES.  Only their ratio moves the MCKP
# choice, and the port keeps the JAX package's values so that its
# decisions match the reference's exactly.  They are not this card's
# speed (device-chosen constants belong with the roofline tools).
PRICE_FLOPS = 197e12
PRICE_BYTES = 819e9


@dataclass
class ServingCostModel:
    cfg: ArchConfig
    dtype_bytes: int = 2
    chips: int = 1

    # ---- per-arch state footprint ------------------------------------------
    def state_bytes(self, n_tokens: int) -> int:
        cfg = self.cfg
        total = 0
        for kind in cfg.layer_kinds():
            if kind == "attn":
                total += (2 * cfg.n_kv_heads * cfg.head_dim * n_tokens
                          * self.dtype_bytes)
            elif kind == "local":
                eff = min(n_tokens, cfg.window or n_tokens)
                total += (2 * cfg.n_kv_heads * cfg.head_dim * eff
                          * self.dtype_bytes)
            elif kind == "mla":
                total += ((cfg.kv_lora_rank + cfg.qk_rope_dim) * n_tokens
                          * self.dtype_bytes)
            elif kind == "mamba":
                total += (cfg.d_inner * (cfg.ssm_state + cfg.d_conv)
                          * self.dtype_bytes)
            elif kind == "rglru":
                w = cfg.lru_width_actual
                total += w * (1 + cfg.d_conv) * self.dtype_bytes
        return total

    def prefill_flops(self, n_tokens: int) -> float:
        _, active = self.cfg.param_count()
        linear = 2.0 * active * n_tokens
        attn = 0.0
        for kind in self.cfg.layer_kinds():
            if kind in ("attn", "mla"):
                dim = (self.cfg.qk_head_dim + (
                    self.cfg.v_head_dim if self.cfg.kv_lora_rank
                    else self.cfg.head_dim)) * self.cfg.n_heads
                attn += 2.0 * n_tokens * n_tokens * dim / 2.0
            elif kind == "local":
                w = self.cfg.window or n_tokens
                dim = 2 * self.cfg.head_dim * self.cfg.n_heads
                attn += 2.0 * n_tokens * min(n_tokens, w) * dim / 2.0
        return linear + attn

    # ---- CostModel protocol (in pricing units, over `chips`) ---------------
    def execution_cost(self, tree: TokenBlock) -> float:
        return self.prefill_flops(tree.n_tokens) / (self.chips * PRICE_FLOPS)

    def output_rows(self, tree: TokenBlock) -> int:
        return tree.n_tokens

    def output_bytes(self, tree: TokenBlock) -> int:
        return self.state_bytes(tree.n_tokens)

    def write_cost(self, tree: TokenBlock) -> float:
        return self.output_bytes(tree) / (self.chips * PRICE_BYTES)

    def read_cost(self, tree: TokenBlock) -> float:
        return self.output_bytes(tree) / (self.chips * PRICE_BYTES)

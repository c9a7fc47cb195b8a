"""Architecture configuration for the LM substrate.

One frozen dataclass covers all 10 registered families (dense / MoE /
MLA / SSM / hybrid / VLM / audio).  Layers are described by a repeating
``pattern`` of block kinds; the decoder loops over full pattern repeats
and then the remainder, so heterogeneous stacks (gemma3 5:1
local:global, recurrentgemma 2:1 RG-LRU:attn) share one block body.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

BLOCK_KINDS = ("attn", "local", "mla", "mamba", "rglru")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    pattern: Tuple[str, ...] = ("attn",)
    window: Optional[int] = None     # sliding window for "local" blocks
    ffn_kind: str = "dense"          # dense|moe
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0           # leading layers with dense FFN
    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- SSM (mamba1) ---
    ssm_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                 # 0 -> ceil(d_model / 16)
    # --- RG-LRU (griffin) ---
    lru_width: int = 0               # 0 -> d_model
    # --- modality frontend stub ---
    frontend: Optional[str] = None   # None|vision|audio
    n_prefix_tokens: int = 0         # precomputed frontend embeddings
    # --- numerics / misc ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- distribution knobs (overridden by launch/sharding.py rules) ---
    fsdp_params: bool = False        # ZeRO-3 over the data axis
    remat: str = "block"             # none|block|full
    scan_layers: bool = True
    attn_impl: str = "xla"           # xla (plain torch) | pallas (kernels)

    # ---- derived -----------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def lru_width_actual(self) -> int:
        return self.lru_width or self.d_model

    @property
    def full_repeats(self) -> int:
        return self.scanned_layers // len(self.pattern)

    @property
    def scanned_layers(self) -> int:
        body = self.n_layers - self.first_k_dense
        return body - (body % len(self.pattern))

    @property
    def remainder_layers(self) -> int:
        return (self.n_layers - self.first_k_dense) % len(self.pattern)

    @property
    def qk_head_dim(self) -> int:
        """Per-head q/k dim (MLA: nope + rope)."""
        if self.kv_lora_rank:
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Block kind of every layer, in order."""
        kinds = []
        for i in range(self.n_layers - self.first_k_dense):
            kinds.append(self.pattern[i % len(self.pattern)])
        prefix = tuple(self.pattern[0] for _ in range(self.first_k_dense))
        return prefix + tuple(kinds)

    def ffn_kind_for_layer(self, layer: int) -> str:
        if self.ffn_kind == "moe" and layer >= self.first_k_dense:
            return "moe"
        return "dense"

    # ---- parameter counting (for roofline MODEL_FLOPS) ---------------------
    def param_count(self) -> Tuple[int, int]:
        """(total_params, active_params) excluding negligible norms."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = active = emb
        for kind in self.layer_kinds():
            if kind in ("attn", "local"):
                if self.kv_lora_rank:  # MLA
                    q_in = (self.q_lora_rank or d)
                    p = (d * self.q_lora_rank if self.q_lora_rank else 0)
                    p += q_in * self.n_heads * (self.qk_nope_dim
                                                + self.qk_rope_dim)
                    p += d * (self.kv_lora_rank + self.qk_rope_dim)
                    p += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.v_head_dim)
                    p += self.n_heads * self.v_head_dim * d
                else:
                    p = d * self.n_heads * self.head_dim          # Wq
                    p += 2 * d * self.n_kv_heads * self.head_dim  # Wk, Wv
                    p += self.n_heads * self.head_dim * d         # Wo
                total += p
                active += p
            elif kind == "mamba":
                di = self.d_inner
                p = d * 2 * di + di * self.d_conv
                p += di * (self.dt_rank_actual + 2 * self.ssm_state)
                p += self.dt_rank_actual * di + di * self.ssm_state + di
                p += di * d
                total += p
                active += p
            elif kind == "rglru":
                w = self.lru_width_actual
                p = 2 * d * w + w * self.d_conv + 3 * w * w + w + w * d
                total += p
                active += p
            # FFN for transformer-ish blocks
            if kind in ("attn", "local"):
                pass
        # FFNs (attn/local blocks have one each; mamba/rglru do not)
        for li, kind in enumerate(self.layer_kinds()):
            if kind in ("mamba",):
                continue
            if kind == "rglru":
                # griffin: every block has an MLP
                ffn_t = ffn_a = 3 * d * self.d_ff
            elif self.ffn_kind_for_layer(li) == "moe":
                e_p = 3 * d * self.d_ff_expert
                ffn_t = self.n_experts * e_p + self.n_shared_experts * e_p
                ffn_a = (self.top_k + self.n_shared_experts) * e_p
            else:
                ffn_t = ffn_a = 3 * d * self.d_ff
            total += ffn_t
            active += ffn_a
        return total, active


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    pat = len(cfg.pattern)
    n_layers = cfg.first_k_dense + max(pat, 2 if pat == 1 else pat) + 1
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, n_layers),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=32,
        d_ff=256,
        d_ff_expert=64 if cfg.n_experts else 0,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        vocab_size=512,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        q_lora_rank=48 if cfg.q_lora_rank else 0,
        qk_nope_dim=32 if cfg.kv_lora_rank else cfg.qk_nope_dim,
        qk_rope_dim=16 if cfg.kv_lora_rank else cfg.qk_rope_dim,
        v_head_dim=32 if cfg.kv_lora_rank else cfg.v_head_dim,
        window=min(cfg.window, 64) if cfg.window else None,
        lru_width=64 if cfg.family == "hybrid" else 0,
        expand=cfg.expand,
        n_prefix_tokens=8 if cfg.n_prefix_tokens else 0,
        dtype="float32",
        scan_layers=True,
    )

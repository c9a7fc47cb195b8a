"""Architecture registry: the ten configurations the system serves.

Each entry is the FULL config from the public source noted beside it;
``get_config("<name>-smoke")`` derives the reduced CPU-test config.
"""
from __future__ import annotations

from typing import Dict

from ..models.config import ArchConfig, smoke_variant

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return smoke_variant(get_config(name[: -len("-smoke")]))
    return _REGISTRY[name]


def list_configs():
    return sorted(_REGISTRY)


# --- llama4-scout-17b-a16e [moe]: 48L d5120 40H (kv8) MoE 16e top-1 ------
register(ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202_048,
    ffn_kind="moe", n_experts=16, top_k=1, d_ff_expert=8192,
    n_shared_experts=1,
    pattern=("attn",), rope_theta=500_000.0, fsdp_params=True,
))

# --- deepseek-v2-236b [moe]: 60L d5120 128H MLA kv_lora 512, 160e top-6 --
register(ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=12_288, vocab_size=102_400,
    pattern=("mla",),
    kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    ffn_kind="moe", n_experts=160, top_k=6, d_ff_expert=1536,
    n_shared_experts=2, first_k_dense=1,
    fsdp_params=True,
))

# --- gemma3-1b [dense]: 26L d1152 4H (kv1) d_ff 6912, 5:1 local:global ---
register(ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262_144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=512, tie_embeddings=True, rope_theta=1_000_000.0,
))

# --- granite-8b [dense]: 36L d4096 32H (kv8) d_ff 14336 -------------------
register(ArchConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab_size=49_152,
    pattern=("attn",), rope_theta=10_000_000.0,
))

# --- phi4-mini-3.8b [dense]: 32L d3072 24H (kv8) d_ff 8192 ----------------
register(ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=200_064,
    pattern=("attn",),
))

# --- gemma3-12b [dense]: 48L d3840 16H (kv8), 5:1 local:global ------------
register(ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15_360, vocab_size=262_144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024, tie_embeddings=True, rope_theta=1_000_000.0,
))

# --- falcon-mamba-7b [ssm]: 64L d4096 attn-free, ssm_state 16 -------------
register(ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=65_024,
    pattern=("mamba",), ssm_state=16, d_conv=4, expand=2,
))

# --- internvl2-2b [vlm]: InternLM2 backbone 24L d2048 16H (kv8) -----------
register(ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92_553,
    pattern=("attn",),
    frontend="vision", n_prefix_tokens=256,   # precomputed ViT patches
))

# --- musicgen-large [audio]: 48L d2048 32H (kv32 = MHA) over EnCodec ------
register(ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048,
    pattern=("attn",),
    frontend="audio", n_prefix_tokens=128,    # conditioning frames
))

# --- recurrentgemma-9b [hybrid]: 38L d4096 16H (kv1), RG-LRU:attn 2:1 -----
register(ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12_288, vocab_size=256_000,
    pattern=("rglru", "rglru", "local"), window=2048,
    lru_width=4096, tie_embeddings=True,
))

ALL_ARCHS = tuple(list_configs())

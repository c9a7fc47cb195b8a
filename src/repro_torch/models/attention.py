"""Attention blocks: GQA (full / sliding-window).

The parallel forward goes through ``flash_attention`` and decode
through ``decode_attention``.  On CUDA tensors both launch their CUDA
kernels whatever ``cfg.attn_impl`` says; on the CPU ``attn_impl`` picks
between the wrapper (``"pallas"``) and the plain version, which on CPU
tensors compute the same thing.  Decode writes the new token's K/V into
the cache IN PLACE (the JAX package returns new buffers): a caller that
must keep a cache unchanged, as the serving engine's prefix pool does,
clones it first.  MLA (DeepSeek-V2) is not ported yet (ROADMAP A8):
the decoder refuses ``mla`` blocks.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.decode_attention.ops import decode
from ..kernels.flash_attention.ops import attention
from .common import ParamSpec, apply_rope
from .config import ArchConfig

def gqa_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": ParamSpec((d, cfg.n_heads * hd), ("embed", "heads"), "lecun"),
        "wk": ParamSpec((d, cfg.n_kv_heads * hd), ("embed", "heads"),
                        "lecun"),
        "wv": ParamSpec((d, cfg.n_kv_heads * hd), ("embed", "heads"),
                        "lecun"),
        "wo": ParamSpec((cfg.n_heads * hd, d), ("heads", "embed"), "lecun"),
    }


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n_heads, -1).transpose(1, 2)


def gqa_forward(p, x: torch.Tensor, cfg: ArchConfig, *,
                window: Optional[int], positions: torch.Tensor,
                dtype) -> torch.Tensor:
    """x: (B, T, d) in ``dtype`` (the parameters' storage dtype)."""
    q = _split_heads(x @ p["wq"], cfg.n_heads)
    k = _split_heads(x @ p["wk"], cfg.n_kv_heads)
    v = _split_heads(x @ p["wv"], cfg.n_kv_heads)
    q = apply_rope(q, positions[None, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[None, None, :], cfg.rope_theta)
    out = attention(q, k, v, True, window, None, cfg.attn_impl)
    b, h, t, hd = out.shape
    out = out.transpose(1, 2).reshape(b, t, h * hd)
    return out @ p["wo"]


def gqa_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(p, x: torch.Tensor, cache: Dict, write_idx: int,
               cfg: ArchConfig, *, window: Optional[int], dtype,
               rope_pos: Optional[int] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d); write_idx: cache slot of the new token; rope_pos:
    its absolute position (defaults to write_idx — they differ for
    rolling sliding-window caches).  Updates ``cache`` in place and
    returns it."""
    b = x.shape[0]
    if rope_pos is None:
        rope_pos = write_idx
    q = _split_heads(x @ p["wq"], cfg.n_heads)
    k = _split_heads(x @ p["wk"], cfg.n_kv_heads)
    v = _split_heads(x @ p["wv"], cfg.n_kv_heads)
    pos = torch.full((1, 1, 1), int(rope_pos), dtype=torch.int32,
                     device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)[:, :, 0]
    k = apply_rope(k, pos, cfg.rope_theta)
    cache["k"][:, :, write_idx:write_idx + 1] = k
    cache["v"][:, :, write_idx:write_idx + 1] = v
    kv_len = torch.full((b,), int(write_idx) + 1, dtype=torch.int32,
                        device=x.device)
    out = decode(q, cache["k"], cache["v"], kv_len, window=window,
                 impl=cfg.attn_impl)
    return out.reshape(b, 1, -1) @ p["wo"], cache

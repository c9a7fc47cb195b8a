"""Attention blocks: GQA (full / sliding-window) and MLA (DeepSeek-V2).

The parallel forward goes through ``flash_attention`` and decode
through ``decode_attention``.  On CUDA tensors both launch their CUDA
kernels whatever ``cfg.attn_impl`` says; on the CPU ``attn_impl`` picks
between the wrapper (``"pallas"``) and the plain version, which on CPU
tensors compute the same thing.  Decode writes the new token's K/V into
the cache IN PLACE (the JAX package returns new buffers): a caller that
must keep a cache unchanged, as the serving engine's prefix pool does,
clones it first.

MLA decodes in the *absorbed* form: the cache stores only the
compressed latent (``kv_lora_rank`` + rope dims per token) and the
up-projections fold into the query and output sides.  Its parallel
forward attends with q/k dim ``nope + rope`` (192 at full width) and v
dim ``v_head_dim``, which neither attention kernel takes; the JAX
package computes it with its plain ``mha_ref``, and so does the port
(plain torch, no kernel wrapper), as it computes the absorbed decode.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.decode_attention.ops import decode
from ..kernels.flash_attention.ops import attention
from ..kernels.flash_attention.ref import mha_ref
from .common import ParamSpec, apply_rope, rmsnorm, rmsnorm_spec
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------
def mla_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, h = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    specs: Dict[str, ParamSpec] = {
        "kv_down": ParamSpec((d, r_kv + rope), ("embed", None), "lecun"),
        "kv_norm": rmsnorm_spec(r_kv),
        "k_up": ParamSpec((r_kv, h * nope), (None, "heads"), "lecun"),
        "v_up": ParamSpec((r_kv, h * vd), (None, "heads"), "lecun"),
        "wo": ParamSpec((h * vd, d), ("heads", "embed"), "lecun"),
    }
    if r_q:
        specs["q_down"] = ParamSpec((d, r_q), ("embed", None), "lecun")
        specs["q_norm"] = rmsnorm_spec(r_q)
        specs["q_up"] = ParamSpec((r_q, h * (nope + rope)),
                                  (None, "heads"), "lecun")
    else:
        specs["q_up"] = ParamSpec((d, h * (nope + rope)),
                                  ("embed", "heads"), "lecun")
    return specs


def _mla_q(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.q_lora_rank:
        q = rmsnorm(p["q_norm"], x @ p["q_down"], cfg.norm_eps) @ p["q_up"]
    else:
        q = x @ p["q_up"]
    return _split_heads(q, cfg.n_heads)        # (B, H, T, nope + rope)


def mla_forward(p, x: torch.Tensor, cfg: ArchConfig, *,
                positions: torch.Tensor, dtype) -> torch.Tensor:
    b, t, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    pos = positions[None, None, :]
    q = _mla_q(p, x, cfg)
    q_rope = apply_rope(q[..., nope:], pos, cfg.rope_theta)
    ckv_full = x @ p["kv_down"]                        # (B, T, r + rope)
    ckv = rmsnorm(p["kv_norm"], ckv_full[..., :r], cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., r:][:, None], pos, cfg.rope_theta)
    k_nope = _split_heads(ckv @ p["k_up"], h)
    v = _split_heads(ckv @ p["v_up"], h)
    k = torch.cat([k_nope, k_rope.expand(b, h, t, rope)], dim=-1)
    q_full = torch.cat([q[..., :nope], q_rope], dim=-1)
    out = mha_ref(q_full, k, v, causal=True,
                  sm_scale=1.0 / ((nope + rope) ** 0.5))
    return out.transpose(1, 2).reshape(b, t, h * vd) @ p["wo"]


def mla_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                              dtype=dtype, device=device),
    }


def mla_decode(p, x: torch.Tensor, cache: Dict, cur_len: int,
               cfg: ArchConfig, *, dtype) -> Tuple[torch.Tensor, Dict]:
    """Absorbed MLA decode over the compressed latent cache.  x: (B, 1,
    d); the new token's latent is written into ``cache`` in place at
    ``cur_len`` and ``cache`` returned."""
    b = x.shape[0]
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope, vd = cfg.qk_nope_dim, cfg.v_head_dim
    pos = torch.full((1, 1, 1), int(cur_len), dtype=torch.int32,
                     device=x.device)
    q = _mla_q(p, x, cfg)[:, :, 0]                     # (B, H, nope + rope)
    q_rope = apply_rope(q[..., nope:][:, :, None], pos,
                        cfg.rope_theta)[:, :, 0]
    ckv_full = x @ p["kv_down"]                        # (B, 1, r + rope)
    cache["ckv"][:, cur_len:cur_len + 1] = rmsnorm(
        p["kv_norm"], ckv_full[..., :r], cfg.norm_eps)
    cache["k_rope"][:, cur_len:cur_len + 1] = apply_rope(
        ckv_full[..., r:][:, None], pos, cfg.rope_theta)[:, 0]
    ckv, k_rope = cache["ckv"], cache["k_rope"]

    # absorb k_up into q: (B, H, nope) x (r, H, nope) -> (B, H, r)
    q_lat = torch.einsum("bhn,rhn->bhr", q[..., :nope],
                         p["k_up"].reshape(r, h, nope))
    s = torch.einsum("bhr,bsr->bhs", q_lat, ckv)
    s = s + torch.einsum("bhe,bse->bhs", q_rope, k_rope)
    s = s.float() / ((nope + cfg.qk_rope_dim) ** 0.5)
    live = torch.arange(ckv.shape[1], device=x.device) <= cur_len
    s = torch.where(live[None, None], s, -1e30)
    w = torch.softmax(s, dim=-1).to(dtype)
    ctx = torch.einsum("bhs,bsr->bhr", w, ckv)         # (B, H, r)
    out = torch.einsum("bhr,rhv->bhv", ctx, p["v_up"].reshape(r, h, vd))
    return out.reshape(b, 1, h * vd) @ p["wo"], cache

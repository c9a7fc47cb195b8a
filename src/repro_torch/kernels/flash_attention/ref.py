"""Plain torch versions of blocked (flash) attention and flash-decode.

The tests hold the JAX package's kernels against these, and
``chip_smoke.py`` holds the CUDA kernels against them on the card; the
kernel wrappers run them only for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch


def _expand_kv(k: torch.Tensor, v: torch.Tensor, group: int):
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    return k, v


def _softmax_rows(logits: torch.Tensor) -> torch.Tensor:
    """exp(logits - row max) with fully masked (-inf) entries at 0."""
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    return torch.where(torch.isfinite(logits), probs, 0.0)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            sm_scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention.

    q: (B, Hq, T, D); k, v: (B, Hkv, S, D); GQA via head repetition.
    Query row i sits at key position i + S - T.  window: a query attends
    to keys in (pos - window, pos]; None = full.
    """
    t, d = q.shape[2], q.shape[3]
    s = k.shape[2]
    k, v = _expand_kv(k, v, q.shape[1] // k.shape[1])
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    qi = torch.arange(t, device=q.device)[:, None] + (s - t)
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= ki > qi - window
    logits = torch.where(mask, logits, float("-inf"))
    probs = _softmax_rows(logits)
    out = torch.einsum("bhts,bhsd->bhtd", probs, v.float())
    denom = probs.sum(-1, keepdim=True)
    return (out / torch.clamp(denom, min=1e-30)).to(q.dtype)


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: torch.Tensor, *, sm_scale: Optional[float] = None,
               window: Optional[int] = None) -> torch.Tensor:
    """Single-token decode.

    q: (B, Hq, D); k, v: (B, Hkv, S, D) padded caches; kv_len: (B,)
    live lengths (the new token's KV already appended).  window: keys
    in [kv_len - window, kv_len).
    """
    d, s = q.shape[2], k.shape[2]
    k, v = _expand_kv(k, v, q.shape[1] // k.shape[1])
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), k.float()) * scale
    ki = torch.arange(s, device=q.device)[None, None, :]
    live = kv_len.to(q.device).long()[:, None, None]
    mask = ki < live
    if window is not None:
        mask &= ki >= live - window
    logits = torch.where(mask, logits, float("-inf"))
    probs = _softmax_rows(logits)
    out = torch.einsum("bhs,bhsd->bhd", probs, v.float())
    denom = probs.sum(-1, keepdim=True)
    return (out / torch.clamp(denom, min=1e-30)).to(q.dtype)

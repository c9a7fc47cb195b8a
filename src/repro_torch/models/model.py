"""Language model wrapper: embeddings, forward, loss and decode step.

Modality frontends (VLM patches / audio frames) are stubs as in the JAX
package: precomputed (B, n_prefix, d_model) embeddings arrive as an
input.  The dry-run stand-ins (``ShapeCell`` / ``input_specs``) wait
for the launch tools (ROADMAP A6).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .common import (ParamSpec, ParamTree, cross_entropy,
                     materialize_params, rmsnorm, rmsnorm_spec)
from .config import ArchConfig
from .decoder import decoder_decode_step, decoder_forward, decoder_specs


def model_specs(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"),
                           "normal"),
        "final_norm": rmsnorm_spec(d),
        "layers": decoder_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, cfg.vocab_size),
                                     ("embed", "vocab"), "lecun")
    return specs


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(cfg: ArchConfig, seed: int = 0,
                device: DeviceLike = None) -> ParamTree:
    """Random parameters from ``seed``, stored in ``cfg.dtype`` (norm
    weights in f32) on ``device`` (``cuda`` unless asked otherwise)."""
    return materialize_params(model_specs(cfg), seed, compute_dtype(cfg),
                              resolve_device(device))


def _logits(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["unembed"]


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------
def forward(params, tokens: torch.Tensor, cfg: ArchConfig,
            prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: (B, T_tok) int -> logits (B, T, V)."""
    dtype = compute_dtype(cfg)
    x = params["embed"][tokens]
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)
    x = decoder_forward(params["layers"], x, cfg, positions, dtype)
    return _logits(params, x, cfg)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
            ) -> torch.Tensor:
    logits = forward(params, batch["tokens"], cfg,
                     prefix_embeds=batch.get("prefix_embeds"))
    labels, mask = batch["labels"], batch.get("mask")
    return cross_entropy(logits[:, : labels.shape[1]], labels, mask)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def decode_step(params, cache, token: torch.Tensor, cur_len: int,
                cfg: ArchConfig) -> Tuple[torch.Tensor, Any]:
    """token: (B, 1) int; returns (logits (B, V), cache).  The cache is
    updated in place (see ``attention.gqa_decode``)."""
    dtype = compute_dtype(cfg)
    x = params["embed"][token]
    x, cache = decoder_decode_step(params["layers"], cache, x, int(cur_len),
                                   cfg, dtype)
    return _logits(params, x, cfg)[:, 0], cache

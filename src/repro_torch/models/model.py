"""Language model wrapper: embeddings, forward, loss and decode step,
and training's f32 masters with their per-step cast (:func:`cast_params`).

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
                     materialize_params, rmsnorm, rmsnorm_spec,
                     storage_dtype)
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


def init_params(cfg: ArchConfig, seed: int = 0, device: DeviceLike = None,
                masters: bool = False) -> ParamTree:
    """Random parameters from ``seed``, stored in ``cfg.dtype`` (norm
    weights in f32) on ``device`` (``cuda`` unless asked otherwise).
    With ``masters``, training's f32 masters instead, every leaf
    requiring grad: the same draws before rounding, so
    ``cast_params(init_params(cfg, s, masters=True), cfg)`` equals
    ``init_params(cfg, s)``."""
    dtype = torch.float32 if masters else compute_dtype(cfg)
    params = materialize_params(model_specs(cfg), seed, dtype,
                                resolve_device(device))
    return params.requires_grad_(masters)


def cast_params(masters, cfg: ArchConfig) -> Dict:
    """The f32 masters cast to the storage dtypes serving uses
    (matrices and embeddings to ``cfg.dtype``, ``ones``-init leaves
    f32), as a nested dict of tensors that :func:`forward` and
    :func:`loss_fn` take.  The cast is differentiable, so gradients of
    a loss over the cast tree land on the masters, as the JAX package's
    casts at every use carry them to its f32 parameters."""
    dtype = compute_dtype(cfg)

    def cast(spec, node):
        if isinstance(spec, ParamSpec):
            return node.to(storage_dtype(spec, dtype))
        if isinstance(spec, dict):
            return {k: cast(v, node[k]) for k, v in spec.items()}
        return [cast(v, n) for v, n in zip(spec, node)]

    return cast(model_specs(cfg), masters)


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

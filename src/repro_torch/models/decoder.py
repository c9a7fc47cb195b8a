"""Decoder stack: pattern-based block assembly, looped over repeats.

A model is ``first_k_dense`` prefix layers + ``full_repeats`` copies of
the layer ``pattern`` + remainder layers.  The JAX package scans a
stacked copy of the pattern's parameters; here ``params["scan"]`` is a
list (an ``nn.ModuleList``) of per-repeat parameter trees and the
decoder loops over it.  Every block kind of ``config.BLOCK_KINDS`` runs:
``attn`` / ``local`` (GQA), ``mla``, ``mamba`` (no MLP) and ``rglru``.

Two entry points per stack: :func:`decoder_forward` (parallel over a
token block; under grad, each pattern repeat is recomputed in the
backward when ``cfg.remat`` asks, as the JAX package checkpoints its
scan body) and :func:`decoder_decode_step` (one token, caches updated
in place).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from . import attention as A
from . import ffn as F
from . import rglru as R
from . import ssm as S
from .common import copy_to_model, rmsnorm, rmsnorm_spec, settle_residual
from .config import ArchConfig


# ---------------------------------------------------------------------------
# per-block specs
# ---------------------------------------------------------------------------
def block_specs(cfg: ArchConfig, kind: str, ffn_kind: str) -> Dict:
    d = cfg.d_model
    specs: Dict[str, Any] = {"norm1": rmsnorm_spec(d)}
    if kind in ("attn", "local"):
        specs["mix"] = A.gqa_specs(cfg)
    elif kind == "mla":
        specs["mix"] = A.mla_specs(cfg)
    elif kind == "mamba":
        specs["mix"] = S.mamba_specs(cfg)
        return specs                       # a mamba block has no MLP
    elif kind == "rglru":
        specs["mix"] = R.rglru_specs(cfg)
    else:
        raise ValueError(kind)
    specs["norm2"] = rmsnorm_spec(d)
    specs["ffn"] = F.ffn_specs(cfg, ffn_kind)
    return specs


def decoder_specs(cfg: ArchConfig) -> Dict:
    """The JAX package's spec tree with ``scan`` as a list over repeats
    (the JAX package stacks the repeats on a leading axis)."""
    specs: Dict[str, Any] = {}
    if cfg.first_k_dense:
        specs["prefix"] = [block_specs(cfg, cfg.pattern[0], "dense")
                           for _ in range(cfg.first_k_dense)]
    if cfg.full_repeats:
        specs["scan"] = [
            {str(p): block_specs(cfg, kind, cfg.ffn_kind)
             for p, kind in enumerate(cfg.pattern)}
            for _ in range(cfg.full_repeats)]
    if cfg.remainder_layers:
        specs["rem"] = [
            block_specs(cfg, cfg.pattern[i % len(cfg.pattern)],
                        cfg.ffn_kind)
            for i in range(cfg.remainder_layers)]
    return specs


def _groups(params, cfg: ArchConfig):
    """The layers in order, grouped as the JAX package lays them out:
    ``(repeat, [(block params, kind, ffn kind), ...])`` with ``repeat``
    true for one pattern repeat of ``scan`` (its scan body) and false
    for a single ``prefix`` or ``rem`` layer."""
    for p in params.get("prefix", []):
        yield False, [(p, cfg.pattern[0], "dense")]
    for layer in params.get("scan", []):
        yield True, [(layer[str(p_i)], kind, cfg.ffn_kind)
                     for p_i, kind in enumerate(cfg.pattern)]
    for i, p in enumerate(params.get("rem", [])):
        yield False, [(p, cfg.pattern[i % len(cfg.pattern)], cfg.ffn_kind)]


def _layers(params, cfg: ArchConfig):
    """(block params, kind, ffn kind) of every layer, in order; the
    index path of each block's cache matches (see ``_caches``)."""
    for _, group in _groups(params, cfg):
        yield from group


# ---------------------------------------------------------------------------
# parallel forward
# ---------------------------------------------------------------------------
def _window(cfg: ArchConfig, kind: str) -> Optional[int]:
    return cfg.window if kind == "local" else None


def block_forward(p, x: torch.Tensor, cfg: ArchConfig, kind: str,
                  ffn_kind: str, positions: torch.Tensor, dtype
                  ) -> torch.Tensor:
    x = settle_residual(x)
    h = copy_to_model(rmsnorm(p["norm1"], x, cfg.norm_eps))
    if kind in ("attn", "local"):
        h = A.gqa_forward(p["mix"], h, cfg, window=_window(cfg, kind),
                          positions=positions, dtype=dtype)
    elif kind == "mla":
        h = A.mla_forward(p["mix"], h, cfg, positions=positions,
                          dtype=dtype)
    elif kind == "mamba":
        return x + S.mamba_forward(p["mix"], h, cfg, dtype)
    elif kind == "rglru":
        h = R.rglru_forward(p["mix"], h, cfg, dtype)
    x = settle_residual(x + h)
    h = copy_to_model(rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x + F.ffn_forward(p["ffn"], h, cfg, ffn_kind, dtype)


def _group_forward(group, x: torch.Tensor, cfg: ArchConfig,
                   positions: torch.Tensor, dtype) -> torch.Tensor:
    for p, kind, ffn_kind in group:
        x = block_forward(p, x, cfg, kind, ffn_kind, positions, dtype)
    return x


def decoder_forward(params, x: torch.Tensor, cfg: ArchConfig,
                    positions: torch.Tensor, dtype) -> torch.Tensor:
    """Every layer in order.  Under grad with ``cfg.remat`` "block" or
    "full", each pattern repeat of ``scan`` keeps only its input for the
    backward and runs again there; ``prefix`` and ``rem`` layers are
    not recomputed, as in the JAX package."""
    remat = cfg.remat in ("block", "full") and torch.is_grad_enabled()
    for repeat, group in _groups(params, cfg):
        if remat and repeat:
            x = checkpoint(_group_forward, group, x, cfg, positions, dtype,
                           use_reentrant=False)
        else:
            x = _group_forward(group, x, cfg, positions, dtype)
    return x


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------
def _kind_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                dtype, device):
    if kind in ("attn", "local"):
        # local layers only ever need a window-sized cache
        n = max_len if kind == "attn" else min(max_len,
                                               cfg.window or max_len)
        return A.gqa_init_cache(cfg, batch, n, dtype, device)
    if kind == "mla":
        return A.mla_init_cache(cfg, batch, max_len, dtype, device)
    if kind == "mamba":
        return S.mamba_init_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return R.rglru_init_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None) -> Dict:
    """Zeroed caches shaped like the parameters: ``prefix`` / ``rem``
    lists, ``scan`` a list over repeats of per-pattern-position dicts,
    on ``device`` (``cuda`` unless asked otherwise)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    device = resolve_device(device)

    def per_block(kind):
        return _kind_cache(cfg, kind, batch, max_len, dtype, device)

    cache: Dict[str, Any] = {}
    if cfg.first_k_dense:
        cache["prefix"] = [per_block(cfg.pattern[0])
                           for _ in range(cfg.first_k_dense)]
    if cfg.full_repeats:
        cache["scan"] = [{str(p): per_block(kind)
                          for p, kind in enumerate(cfg.pattern)}
                         for _ in range(cfg.full_repeats)]
    if cfg.remainder_layers:
        cache["rem"] = [per_block(cfg.pattern[i % len(cfg.pattern)])
                        for i in range(cfg.remainder_layers)]
    return cache


def _caches(cache: Dict, cfg: ArchConfig):
    """Every block's cache dict, in the order of ``_layers``."""
    yield from cache.get("prefix", [])
    for layer in cache.get("scan", []):
        for p_i in range(len(cfg.pattern)):
            yield layer[str(p_i)]
    yield from cache.get("rem", [])


def _block_decode(p, x, cache, cur_len: int, cfg: ArchConfig, kind: str,
                  ffn_kind: str, dtype):
    """One token through one block; the residual stream is settled where
    :func:`block_forward` settles it."""
    x = settle_residual(x)
    h = copy_to_model(rmsnorm(p["norm1"], x, cfg.norm_eps))
    if kind == "mla":
        h, cache = A.mla_decode(p["mix"], h, cache, cur_len, cfg,
                                dtype=dtype)
    elif kind == "mamba":
        h, cache = S.mamba_decode(p["mix"], h, cache, cfg, dtype)
        return x + h, cache
    elif kind == "rglru":
        h, cache = R.rglru_decode(p["mix"], h, cache, cfg, dtype)
    elif kind == "local" and cfg.window is not None:
        # the local cache is a rolling window: once full, older entries
        # roll off and the new token takes the last slot, while RoPE
        # keeps the absolute position so relative phases stay correct
        wlen = cache["k"].shape[2]
        if cur_len >= wlen:
            for name in ("k", "v"):
                A.roll_slots(cache[name])
        h, cache = A.gqa_decode(p["mix"], h, cache, min(cur_len, wlen - 1),
                                cfg, window=None, dtype=dtype,
                                rope_pos=cur_len)
    else:
        h, cache = A.gqa_decode(p["mix"], h, cache, cur_len, cfg,
                                window=None, dtype=dtype)
    x = settle_residual(x + h)
    h = copy_to_model(rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x + F.ffn_forward(p["ffn"], h, cfg, ffn_kind, dtype,
                             decode=True), cache


def decoder_decode_step(params, cache, x: torch.Tensor, cur_len: int,
                        cfg: ArchConfig, dtype) -> Tuple[torch.Tensor, Dict]:
    """One token through every layer; ``cache`` is updated in place and
    returned."""
    for (p, kind, ffn_kind), c in zip(_layers(params, cfg),
                                      _caches(cache, cfg)):
        x, _ = _block_decode(p, x, c, cur_len, cfg, kind, ffn_kind, dtype)
    return x, cache


def map_cache(cache, fn):
    """Apply ``fn`` to every tensor of a cache tree (dicts / lists)."""
    if isinstance(cache, torch.Tensor):
        return fn(cache)
    if isinstance(cache, dict):
        return {k: map_cache(v, fn) for k, v in cache.items()}
    return [map_cache(v, fn) for v in cache]

"""Language model wrapper: embeddings, forward, loss and decode step,
and training's f32 masters with their per-step cast (:func:`cast_params`).

Modality frontends (VLM patches / audio frames) are stubs as in the JAX
package: precomputed (B, n_prefix, d_model) embeddings arrive as an
input.  ``ShapeCell`` / ``SHAPES`` name the assignment's step shapes,
which the sharding rules take, and :func:`input_specs` gives shape and
dtype stand-ins (``meta`` tensors) of each cell's inputs, which the
multi-device dry run (``launch/dryrun.py``) traces against.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .common import (ParamSpec, ParamTree, _is_dtensor, constrain,
                     copy_to_model, cross_entropy, gathered_on_use,
                     materialize_params, reduce_from_model, rmsnorm,
                     rmsnorm_spec, settle_residual, shard_range,
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


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``.  A DTensor table is looked up
    where it lies (:func:`_vocab_parallel_lookup`); a plain one is
    indexed."""
    table = params["embed"]
    if _is_dtensor(table):
        return _vocab_parallel_lookup(table, tokens)
    return table[tokens]


def _vocab_parallel_lookup(table, tokens):
    """The vocab-parallel lookup of a DTensor ``table`` (V, d): each
    rank of a mesh dim that splits the vocab looks up the tokens its own
    rows hold, zeros for the others, and the partial sums reduce over
    that dim (one all-reduce of (B, T, d)), so the table never moves and
    the gradient lands in each rank's own rows.  An embedding dim split
    over a mesh dim (FSDP) is gathered first, as ZeRO-3 gathers a weight
    on use.  The rows come out split like the tokens and whole
    otherwise."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    vocab = [i for i, pl in enumerate(table.placements)
             if isinstance(pl, Shard) and pl.dim == 0]
    tp = [pl if i in vocab else Replicate()
          for i, pl in enumerate(table.placements)]
    table = table.redistribute(mesh, tp)
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    kp = [Replicate() if i in vocab else pl
          for i, pl in enumerate(tokens.placements)]
    tokens = tokens.redistribute(mesh, kp)
    begin, rows = shard_range(table, 0)
    # the gradient of the rows a rank holds sums over the ranks that
    # split the tokens
    gp = [pl if i in vocab else
          Partial() if isinstance(kp[i], Shard) else Replicate()
          for i, pl in enumerate(tp)]
    local = table.to_local(grad_placements=gp)
    ids = tokens.to_local().long() - begin
    if not vocab:
        return DTensor.from_local(local[ids], mesh, kp, run_check=False)
    mine = (ids >= 0) & (ids < rows)
    out = local[torch.where(mine, ids, 0)] * mine[..., None].to(local.dtype)
    pls = [Partial() if i in vocab else pl for i, pl in enumerate(kp)]
    return reduce_from_model(DTensor.from_local(out, mesh, pls,
                                                run_check=False))


def _logits(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits (B, T, V).  On DTensors the head is a column-parallel
    product: the normed stream meets the table (or the unembedding)
    where it lies, split by vocab, and the logits stay split by vocab
    (the vocab-parallel :func:`~.common.cross_entropy` reads them so),
    in training by rows as the stream is too."""
    x = copy_to_model(rmsnorm(params["final_norm"], x, cfg.norm_eps))
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return constrain(x @ gathered_on_use(w), ("batch", None, "vocab"))


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------
def forward(params, tokens: torch.Tensor, cfg: ArchConfig,
            prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: (B, T_tok) int -> logits (B, T, V)."""
    dtype = compute_dtype(cfg)
    x = _embed(params, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
    x = constrain(x, ("batch", None, None))
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)
    x = decoder_forward(params["layers"], x, cfg, positions, dtype)
    return _logits(params, settle_residual(x), cfg)


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
    x = _embed(params, token)
    x, cache = decoder_decode_step(params["layers"], cache, x, int(cur_len),
                                   cfg, dtype)
    return _logits(params, settle_residual(x), cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# the assignment's step shapes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    step: str                 # "train" | "prefill" | "decode"


SHAPES = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def input_specs(cfg: ArchConfig, shape: ShapeCell) -> Dict[str, torch.Tensor]:
    """Stand-ins (tensors on the ``meta`` device, never allocated) for
    each input of the cell's step function, with the JAX package's
    shapes and dtypes."""
    b, t = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.step == "decode":
        # one new token against a KV / state cache of length t
        return {"token": meta((b, 1), torch.int32)}
    specs = {"tokens": meta((b, t - cfg.n_prefix_tokens), torch.int32)}
    if shape.step == "train":
        specs["labels"] = meta((b, t), torch.int32)
        specs["mask"] = meta((b, t), torch.float32)
    if cfg.n_prefix_tokens:
        specs["prefix_embeds"] = meta((b, cfg.n_prefix_tokens, cfg.d_model),
                                      compute_dtype(cfg))
    return specs

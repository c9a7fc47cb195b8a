"""Mamba-1 selective SSM block (falcon-mamba-7b).

The parallel forward runs the time recurrence as a loop over the
sequence (the JAX package's ``lax.scan``), through ``scan_ops.ssm_scan``,
which is one custom operator under a trace.  Decode keeps an O(1)-size
state per layer, (conv window, SSM state), and updates it IN PLACE, as
``attention.gqa_decode`` does its KV cache — which is also why the
serving-layer MQO gives SSM prefixes a near-zero knapsack weight.  The
block computes in plain torch: the JAX package has no Pallas kernel for
it either.

``A_log`` and ``D`` are ``ones``-init leaves, which the port stores in
f32 (``common.storage_dtype``); they are cast where the JAX package
casts them, so that no f32 promotion reaches the activations or the
caches.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import ParamSpec, copy_to_model, row_parallel
from .config import ArchConfig
from .ffn import _all_to_all
from .scan_ops import on_local_shards, ssm_scan


def mamba_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, di, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dr = cfg.dt_rank_actual
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "ffn"), "lecun"),
        "conv_w": ParamSpec((di, cfg.d_conv), ("ffn", None), "lecun"),
        "conv_b": ParamSpec((di,), ("ffn",), "zeros"),
        "x_proj": ParamSpec((di, dr + 2 * st), ("ffn", None), "lecun"),
        "dt_proj": ParamSpec((dr, di), (None, "ffn"), "lecun"),
        "dt_bias": ParamSpec((di,), ("ffn",), "zeros"),
        "A_log": ParamSpec((di, st), ("ffn", None), "ones"),
        "D": ParamSpec((di,), ("ffn",), "ones"),
        "out_proj": ParamSpec((di, d), ("ffn", "embed"), "lecun"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time.  x: (B, T, di); w: (di, K).

    A cross-correlation, as the JAX package's ``conv_general_dilated``:
    out[t] = b + sum_j w[:, j] * x[t + j - (K - 1)], zeros before t = 0.
    Written as K shifted multiply-adds, so that no cuDNN convolution
    (TF32 by default on the card) computes it.  On DTensors each rank
    convolves its own rows and channels (``scan_ops.on_local_shards``):
    on torch 2.11, DTensor's propagation through this function gave a
    placement list shorter than the mesh."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return on_local_shards(_causal_conv, (x, w, b),
                               ("act", "chans", "chans"))
    kk = w.shape[1]
    t = x.shape[1]
    xp = F.pad(x, (0, 0, kk - 1, 0))                   # (B, T + K - 1, di)
    out = xp[:, 0:t] * w[:, 0]
    for j in range(1, kk):
        out = out + xp[:, j:j + t] * w[:, j]
    return out + b


def _split_proj(proj: torch.Tensor, cfg: ArchConfig):
    dr, st = cfg.dt_rank_actual, cfg.ssm_state
    return proj[..., :dr], proj[..., dr:dr + st], proj[..., dr + st:]


def _a_matrix(p, dtype) -> torch.Tensor:
    """A = -exp(A_log) in f32, then cast to the compute dtype."""
    return (-torch.exp(p["A_log"].float())).to(dtype)


def _in_proj(x: torch.Tensor, w: torch.Tensor):
    """(x_in, z) = the two halves of ``x @ w``.  Where ``w`` is a DTensor
    whose columns a mesh dim splits, the halves of the product would
    each lie on half of those ranks, and DTensor gathers the (B, T, 2 di)
    product to take them.  So the weight, (d, 2 di), is gathered along
    its columns instead, halved on each rank, and each half placed back
    as ``w`` is multiplies ``x`` on its own."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(w, DTensor):
        return (x @ w).chunk(2, dim=-1)
    mesh = w.device_mesh
    whole = [Replicate() if pl == Shard(1) else pl for pl in w.placements]
    halves = w.redistribute(mesh, whole).to_local().chunk(2, dim=-1)
    return tuple(x @ DTensor.from_local(h, mesh, whole, run_check=False
                                        ).redistribute(mesh, w.placements)
                 for h in halves)


def _in_proj_token(x: torch.Tensor, w: torch.Tensor):
    """(x_in, z) = the two halves of ``x @ w`` for a decode step's rows
    x (B, d).  Where ``w`` is a DTensor whose columns one mesh dim of n
    ranks splits (n even, 2 di a multiple of 2n), rank j's block of the
    product lies in one half, and its two parts are the blocks of ranks
    2 (j mod n/2) and 2 (j mod n/2) + 1 in that half's split: one
    all-to-all over that dim of a rank's (B, 2 di / n) elements places
    both halves as the weight's columns are placed.  DTensor would
    gather the product for ``chunk``, and the forward's :func:`_in_proj`
    gathers the weight, which a step of one token cannot repay."""
    from torch.distributed.tensor import DTensor, Shard

    xz = x @ w
    if not isinstance(xz, DTensor):
        return xz.chunk(2, dim=-1)
    mesh, last = xz.device_mesh, xz.ndim - 1
    cols = [i for i, pl in enumerate(xz.placements) if pl == Shard(last)]
    n = mesh.size(cols[0]) if len(cols) == 1 else 0
    if n < 2 or n % 2 or xz.shape[last] % (2 * n):
        return xz.chunk(2, dim=-1)
    j, half = mesh.get_local_rank(cols[0]), n // 2
    loc = xz.to_local()
    parts = loc.reshape(loc.shape[:last] + (2, -1)).movedim(last, 0)
    send = [int(i // 2 == j % half) for i in range(n)]
    recv = [int(i % half == j // 2) for i in range(n)]
    got = _all_to_all(parts, send, recv, (mesh, cols[0]))
    shape = xz.shape[:last] + (xz.shape[last] // 2,)
    return tuple(DTensor.from_local(t, mesh, xz.placements, run_check=False,
                                    shape=shape,
                                    stride=torch.empty(shape, device="meta"
                                                       ).stride())
                 for t in got)


def mamba_forward(p, x: torch.Tensor, cfg: ArchConfig, dtype
                  ) -> torch.Tensor:
    x_in, z = _in_proj(x, p["in_proj"])
    x_in = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
    # a row-parallel product on DTensors, (B, T, dt_rank + 2 st): summed
    # now, so that dt_proj multiplies each rank's columns only and the
    # scan reads Bm and Cm whole; their gradients, partial over the
    # channels' ranks, are summed back here
    dt, Bm, Cm = _split_proj(copy_to_model(row_parallel(x_in, p["x_proj"])),
                             cfg)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    y = ssm_scan(dt, Bm, Cm, x_in, _a_matrix(p, dtype), p["D"].to(dtype))
    return row_parallel(y * F.silu(z), p["out_proj"])


def mamba_init_cache(cfg: ArchConfig, batch: int, dtype, device=None
                     ) -> Dict[str, torch.Tensor]:
    di = cfg.d_inner
    return {
        "conv": torch.zeros((batch, di, cfg.d_conv), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.ssm_state), dtype=dtype,
                           device=device),
    }


def mamba_decode(p, x: torch.Tensor, cache: Dict, cfg: ArchConfig, dtype
                 ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d) -> (B, 1, d); the O(1) state is updated in place and
    ``cache`` returned."""
    x_in, z = _in_proj_token(x[:, 0], p["in_proj"])   # (B, di)
    conv = torch.cat([cache["conv"][:, :, 1:], x_in[:, :, None]], dim=2)
    x_c = F.silu((conv * p["conv_w"]).sum(-1) + p["conv_b"])
    # summed as in the forward: dt_proj multiplies each rank's columns
    dt, Bm, Cm = _split_proj(copy_to_model(row_parallel(x_c, p["x_proj"])),
                             cfg)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])  # (B, di)
    da = torch.exp(dt[..., None] * _a_matrix(p, dtype))   # (B, di, st)
    h = da * cache["ssm"] + (dt * x_c)[..., None] * Bm[:, None, :]
    y = torch.einsum("bds,bs->bd", h, Cm) + x_c * p["D"].to(dtype)
    out = row_parallel(y * F.silu(z), p["out_proj"])[:, None]
    cache["conv"].copy_(conv)
    cache["ssm"].copy_(h)
    return out, cache

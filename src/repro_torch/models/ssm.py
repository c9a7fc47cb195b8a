"""Mamba-1 selective SSM block (falcon-mamba-7b).

The parallel forward runs the time recurrence as a loop over the
sequence (the JAX package's ``lax.scan``).  Decode keeps an O(1)-size
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

from .common import ParamSpec
from .config import ArchConfig


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
    (TF32 by default on the card) computes it."""
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


def _ssm_scan(dt, Bm, Cm, x_in, A, D):
    """dt, x_in: (B, T, di); Bm, Cm: (B, T, st); A: (di, st)."""
    da = torch.exp(dt[..., None] * A)                  # (B, T, di, st)
    db_x = (dt * x_in)[..., None] * Bm[:, :, None, :]  # (B, T, di, st)
    h = torch.zeros_like(da[:, 0])
    ys = []
    for t in range(da.shape[1]):
        h = da[:, t] * h + db_x[:, t]
        ys.append(torch.einsum("bds,bs->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1) + x_in * D


def mamba_forward(p, x: torch.Tensor, cfg: ArchConfig, dtype
                  ) -> torch.Tensor:
    xz = x @ p["in_proj"]
    x_in, z = xz.chunk(2, dim=-1)
    x_in = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
    dt, Bm, Cm = _split_proj(x_in @ p["x_proj"], cfg)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    y = _ssm_scan(dt, Bm, Cm, x_in, _a_matrix(p, dtype), p["D"].to(dtype))
    return (y * F.silu(z)) @ p["out_proj"]


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
    xz = x[:, 0] @ p["in_proj"]
    x_in, z = xz.chunk(2, dim=-1)                      # (B, di)
    conv = torch.cat([cache["conv"][:, :, 1:], x_in[:, :, None]], dim=2)
    x_c = F.silu((conv * p["conv_w"]).sum(-1) + p["conv_b"])
    dt, Bm, Cm = _split_proj(x_c @ p["x_proj"], cfg)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])  # (B, di)
    da = torch.exp(dt[..., None] * _a_matrix(p, dtype))   # (B, di, st)
    h = da * cache["ssm"] + (dt * x_c)[..., None] * Bm[:, None, :]
    y = torch.einsum("bds,bs->bd", h, Cm) + x_c * p["D"].to(dtype)
    out = ((y * F.silu(z)) @ p["out_proj"])[:, None]
    cache["conv"].copy_(conv)
    cache["ssm"].copy_(h)
    return out, cache

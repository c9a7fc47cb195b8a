"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Real-Gated Linear Recurrent Unit: per-channel learned decay gated by
the input, h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t), inside
a gated two-branch block with a short causal conv (no SiLU after it,
unlike Mamba).  Decode state is O(1) per layer (conv window + h) and is
updated in place, as the other blocks' caches are.  Plain torch: the
JAX package has no Pallas kernel for the block either.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import ParamSpec
from .config import ArchConfig
from .ssm import _causal_conv

_C = 8.0  # Griffin's recurrence sharpness constant


def rglru_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, w = cfg.d_model, cfg.lru_width_actual
    return {
        "in_x": ParamSpec((d, w), ("embed", "ffn"), "lecun"),
        "in_gate": ParamSpec((d, w), ("embed", "ffn"), "lecun"),
        "conv_w": ParamSpec((w, cfg.d_conv), ("ffn", None), "lecun"),
        "conv_b": ParamSpec((w,), ("ffn",), "zeros"),
        "w_input_gate": ParamSpec((w, w), ("ffn", None), "lecun"),
        "w_rec_gate": ParamSpec((w, w), ("ffn", None), "lecun"),
        "lam": ParamSpec((w,), ("ffn",), "ones"),
        "out": ParamSpec((w, d), ("ffn", "embed"), "lecun"),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _gates(p, xc, dtype):
    i_t = torch.sigmoid(xc @ p["w_input_gate"])
    r_t = torch.sigmoid(xc @ p["w_rec_gate"])
    log_a = -_C * F.softplus(p["lam"].float()) * r_t.float()
    a_t = torch.exp(log_a).to(dtype)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)
                      ).to(dtype)
    return i_t, a_t, beta


def rglru_forward(p, x: torch.Tensor, cfg: ArchConfig, dtype
                  ) -> torch.Tensor:
    xb = x @ p["in_x"]                                 # (B, T, w)
    gate = _gelu(x @ p["in_gate"])
    xc = _causal_conv(xb, p["conv_w"], p["conv_b"])
    i_t, a_t, beta = _gates(p, xc, dtype)
    gx = beta * (i_t * xc)
    h = torch.zeros_like(xc[:, 0])
    hs = []
    for t in range(xc.shape[1]):
        h = a_t[:, t] * h + gx[:, t]
        hs.append(h)
    return (torch.stack(hs, dim=1) * gate) @ p["out"]


def rglru_init_cache(cfg: ArchConfig, batch: int, dtype, device=None
                     ) -> Dict[str, torch.Tensor]:
    w = cfg.lru_width_actual
    return {
        "conv": torch.zeros((batch, w, cfg.d_conv), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, w), dtype=dtype, device=device),
    }


def rglru_decode(p, x: torch.Tensor, cache: Dict, cfg: ArchConfig, dtype
                 ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d) -> (B, 1, d); the state is updated in place and
    ``cache`` returned."""
    xb = x[:, 0] @ p["in_x"]                           # (B, w)
    gate = _gelu(x[:, 0] @ p["in_gate"])
    conv = torch.cat([cache["conv"][:, :, 1:], xb[:, :, None]], dim=2)
    xc = (conv * p["conv_w"]).sum(-1) + p["conv_b"]
    i_t, a_t, beta = _gates(p, xc, dtype)
    h = a_t * cache["h"] + beta * (i_t * xc)
    out = ((h * gate) @ p["out"])[:, None]
    cache["conv"].copy_(conv)
    cache["h"].copy_(h)
    return out, cache

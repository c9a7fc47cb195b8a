"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Real-Gated Linear Recurrent Unit: per-channel learned decay gated by
the input, h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t), inside
a gated two-branch block with a short causal conv (no SiLU after it,
unlike Mamba).  The parallel forward's recurrence is
``scan_ops.rglru_scan``, a loop over the sequence that is one custom
operator under a trace.  Decode state is O(1) per layer (conv window +
h) and is updated in place, as the other blocks' caches are.  Plain
torch: the JAX package has no Pallas kernel for the block either.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import ParamSpec, row_parallel
from .config import ArchConfig
from .scan_ops import rglru_scan
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


def _gates(p, xc, dtype, gate_sums=lambda t: t):
    """(i_t, a_t, beta); ``gate_sums`` takes each gate's product before
    its sigmoid."""
    i_t = torch.sigmoid(gate_sums(xc @ p["w_input_gate"]))
    r_t = torch.sigmoid(gate_sums(xc @ p["w_rec_gate"]))
    log_a = -_C * F.softplus(p["lam"].float()) * r_t.float()
    a_t = torch.exp(log_a).to(dtype)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)
                      ).to(dtype)
    return i_t, a_t, beta


def _scatter_channels(t: torch.Tensor) -> torch.Tensor:
    """A DTensor of partial sums (B, T, w), the gates' row-parallel
    products, summed and split along its channels (a reduce-scatter), so
    that the gates, the recurrence's inputs and the scan stay on each
    rank's channels; DTensor would otherwise sum them whole, and gather
    the scan's inputs to that layout.  Anything else as it is."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return t
    pls = [Shard(t.ndim - 1) if pl.is_partial() else pl
           for pl in t.placements]
    return t if pls == list(t.placements) else \
        t.redistribute(t.device_mesh, pls)


def rglru_forward(p, x: torch.Tensor, cfg: ArchConfig, dtype
                  ) -> torch.Tensor:
    xb = x @ p["in_x"]                                 # (B, T, w)
    gate = _gelu(x @ p["in_gate"])
    xc = _causal_conv(xb, p["conv_w"], p["conv_b"])
    i_t, a_t, beta = _gates(p, xc, dtype, _scatter_channels)
    gx = beta * (i_t * xc)
    return row_parallel(rglru_scan(a_t, gx) * gate, p["out"])


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
    i_t, a_t, beta = _gates(p, xc, dtype, _scatter_channels)
    h = a_t * cache["h"] + beta * (i_t * xc)
    out = row_parallel(h * gate, p["out"])[:, None]
    cache["conv"].copy_(conv)
    cache["h"].copy_(h)
    return out, cache

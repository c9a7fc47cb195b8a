"""FFN blocks: dense SwiGLU.  Mixture-of-Experts is not ported yet
(ROADMAP A8)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import ParamSpec
from .config import ArchConfig

MOE_NOT_PORTED = "the MoE FFN is not ported yet (ROADMAP A8)"


def dense_specs(cfg: ArchConfig, d_ff: int | None = None
                ) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w1": ParamSpec((d, f), ("embed", "ffn"), "lecun"),
        "w3": ParamSpec((d, f), ("embed", "ffn"), "lecun"),
        "w2": ParamSpec((f, d), ("ffn", "embed"), "lecun"),
    }


def dense_forward(p, x: torch.Tensor, dtype) -> torch.Tensor:
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]


def ffn_specs(cfg: ArchConfig, kind: str) -> Dict[str, ParamSpec]:
    if kind == "moe":
        raise NotImplementedError(MOE_NOT_PORTED)
    return dense_specs(cfg)


def ffn_forward(p, x: torch.Tensor, cfg: ArchConfig, kind: str, dtype
                ) -> torch.Tensor:
    if kind == "moe":
        raise NotImplementedError(MOE_NOT_PORTED)
    return dense_forward(p, x, dtype)

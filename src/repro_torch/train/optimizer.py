"""AdamW + cosine schedule + global-norm clipping over a tree of tensors.

The JAX package's optimizer (``repro/train/optimizer.py``) on torch.
The optimizer state (m, v) is f32 and has the parameters' tree
structure; ``step`` is an int32 0-dim tensor on the parameters' device.
The scalar math (the learning rate, the bias corrections, the clip
scale) runs in f32 tensors in the JAX package's order: Python floats
enter only where the JAX package rounds them to f32 too, and no scalar
is divided by a tensor through Python's ``/`` (torch computes
``c / t`` as ``c * (1 / t)``, which rounds differently).  The update
writes the parameters, m and v in place; the JAX package donates those
buffers to its jitted step, so no caller keeps the old values.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..models.common import named_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def lr_schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``min_lr_ratio * peak_lr`` at ``decay_steps``; an f32 0-dim tensor."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    progress = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.decay_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, decayed)


def init_opt_state(params) -> Dict[str, Any]:
    """Zero f32 m and v shaped like ``params``, and step 0."""
    first = named_leaves(params)[0][1]
    return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for _, x in named_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping.  ``grads`` has the
    leaves of ``params`` in the same order.  Writes ``params`` and the
    state's m and v in place and returns (params, state, metrics) with
    metrics ``lr`` and ``grad_norm`` (0-dim f32 tensors)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, gnorm),
                          torch.div(_f32(cfg.grad_clip, gnorm),
                                    torch.clamp(gnorm, min=1e-9)))
    b1, b2 = cfg.b1, cfg.b2
    one = _f32(1.0, gnorm)
    bc1 = one - torch.pow(_f32(b1, gnorm), step.to(torch.float32))
    bc2 = one - torch.pow(_f32(b2, gnorm), step.to(torch.float32))
    lr = lr_schedule(step, cfg)
    for (_, p), (_, g), (_, m), (_, v) in zip(
            named_leaves(params), named_leaves(grads),
            named_leaves(state["m"]), named_leaves(state["v"])):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        pf = p.to(torch.float32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics

"""Shared LM building blocks: parameter specs, RMSNorm, RoPE, CE loss.

Every parameter is declared through a ``ParamSpec`` (shape, logical
axes, init rule).  :func:`materialize_params` turns a spec tree into a
:class:`ParamTree` module drawn from an explicit ``torch.Generator``,
tensor by tensor, directly in its storage dtype on its device: matrices
and embeddings in the config's dtype (the JAX package keeps f32 masters
and casts at every use; rounding once at init gives the same values and
keeps a bf16 model from being re-cast on every step), ``ones``-init
leaves in f32: RMSNorm weights, which the norm reads in f32, and Mamba's
``A_log`` / ``D`` and RG-LRU's ``lam``, which their blocks cast where the
JAX package casts them.  Training draws the same values in f32 as
masters (``model.init_params(..., masters=True)``) and casts them to
these storage dtypes at every step (``model.cast_params``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]   # e.g. ("embed", "ffn")
    init: str = "normal"                      # normal|zeros|ones|lecun
    scale: float = 1.0
    dtype: str = "float32"

    def std(self) -> float:
        """Standard deviation of a ``normal`` / ``lecun`` draw."""
        fan_in = self.shape[0] if len(self.shape) >= 1 else 1
        if self.init == "lecun":
            return (1.0 / max(fan_in, 1)) ** 0.5 * self.scale
        return 0.02 * self.scale

    def materialize(self, gen: torch.Generator, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        out = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                          device=device)
        return out.mul_(self.std()).to(dtype)


SpecTree = Dict


def storage_dtype(spec: ParamSpec, dtype: torch.dtype) -> torch.dtype:
    """``ones``-init leaves (RMSNorm weights, ``A_log``, ``D``, ``lam``)
    stay f32; the rest use ``dtype``."""
    return torch.float32 if spec.init == "ones" else dtype


class ParamTree(nn.Module):
    """A nested parameter dict as a module: ``p["wq"]``, ``p["mix"]``,
    ``p["scan"][r]``.  Lists become ``nn.ModuleList``s, so the
    ``state_dict`` keys read like the JAX package's tree paths with the
    repeat index spelled out (``layers.scan.0.0.mix.wq``).  A leaf
    requires grad when the tensor it is given does (training's f32
    masters); serving's leaves do not.  Subtrees may come as ParamTrees
    already."""

    def __init__(self, tree: Dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, torch.Tensor):
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=val.requires_grad))
            elif isinstance(val, ParamTree):
                self.add_module(key, val)
            elif isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.add_module(key, nn.ModuleList(
                    v if isinstance(v, ParamTree) else ParamTree(v)
                    for v in val))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default


def children(node) -> List[Tuple[str, Any]]:
    """(key, child) pairs of a tree node: a dict, a list, a ParamTree
    (its leaves, then its subtrees) or an ``nn.ModuleList``."""
    if isinstance(node, ParamTree):
        return list(node._parameters.items()) + list(node._modules.items())
    if isinstance(node, dict):
        return list(node.items())
    return [(str(i), v) for i, v in enumerate(node)]


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of a tree of tensors (dicts, lists,
    ParamTrees), keys joined with "/" as the JAX package's checkpoint
    keys are (``layers/scan/0/0/mix/wq``)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    out: List[Tuple[str, torch.Tensor]] = []
    for key, child in children(tree):
        out += named_leaves(child, f"{prefix}/{key}" if prefix else key)
    return out


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf of ``tree``; the result has the
    structure of ``tree``, with a ParamTree wherever ``tree`` has one."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    mapped = {key: tree_map(fn, child) for key, child in children(tree)}
    if isinstance(tree, ParamTree):
        return ParamTree(mapped)
    if isinstance(tree, dict):
        return mapped
    return list(mapped.values())


def map_specs(specs, fn):
    """Apply ``fn(spec)`` to every leaf of a spec tree (dicts / lists)."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: map_specs(v, fn) for k, v in specs.items()}
    return [map_specs(v, fn) for v in specs]


def materialize_params(specs: SpecTree, seed: int, dtype: torch.dtype,
                       device: torch.device) -> ParamTree:
    """Draw every leaf from one generator seeded with ``seed``, in spec
    order, on ``device``.  Draws differ from the JAX package's (another
    generator); tests carry parameters across instead
    (``carry.params_from_reference``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return ParamTree(map_specs(specs, lambda s: s.materialize(
        gen, storage_dtype(s, dtype), device)))


# ---------------------------------------------------------------------------
# normalization / rope / loss
# ---------------------------------------------------------------------------
def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), (None,), init="ones")


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: Union[torch.device, None] = None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., T, D) with D even; positions: (..., T) int, f32 math."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    ang = positions[..., None].float() * freqs                # (..., T, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over (B, T, V) logits and (B, T) int labels, f32 math."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()

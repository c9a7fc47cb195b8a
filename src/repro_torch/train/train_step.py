"""The train step: loss and gradients over the f32 masters, then AdamW.

The JAX package's ``make_train_step`` (``repro/train/train_step.py``)
on torch.  The step casts the masters to the storage dtypes the model
computes in (``models.model.cast_params``), runs ``loss_fn`` on the
cast tree and takes the gradients of the masters through the cast, as
the JAX package's ``value_and_grad`` differentiates its casts at every
use.  Its gradient-compressed ``shard_map`` step needs a mesh and waits
for the multi-device port.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..models.common import named_leaves, tree_map
from ..models.config import ArchConfig
from ..models.model import cast_params, loss_fn
from .optimizer import OptConfig, adamw_update, init_opt_state


def value_and_grad(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """(loss, grads): the loss over the cast masters and its gradient
    for each master, as a tree shaped like ``params``."""
    leaves = [p for _, p in named_leaves(params)]
    loss = loss_fn(cast_params(params, cfg), batch, cfg)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``lr`` and ``grad_norm``; the
    masters and the optimizer state are updated in place."""

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch, cfg)
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def init_train_state(cfg: ArchConfig, params) -> Dict[str, Any]:
    """The optimizer state a step starts from, under the JAX package's
    name and signature."""
    return init_opt_state(params)

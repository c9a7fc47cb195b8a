"""The train step: loss and gradients over the f32 masters, then AdamW.

The JAX package's ``make_train_step`` (``repro/train/train_step.py``)
on torch.  The step casts the masters to the storage dtypes the model
computes in (``models.model.cast_params``), runs ``loss_fn`` on the
cast tree and takes the gradients of the masters through the cast, as
the JAX package's ``value_and_grad`` differentiates its casts at every
use.

On an SPMD rank the same step runs on DTensor masters placed by
``launch.sharding.param_shardings`` and a batch placed by
``batch_shardings``: DTensor carries the tensor-parallel products and
the data-parallel gradient reduction, and plain tensors the model makes
(positions, RoPE tables) count as replicated.
:func:`make_compressed_train_step` is the data-parallel step with its
gradients all-reduced in bf16 and the rounding error fed back.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Tuple

import torch

from ..models.common import named_leaves, tree_map
from ..models.config import ArchConfig
from ..models.model import cast_params, loss_fn
from .optimizer import OptConfig, adamw_update, init_opt_state


def value_and_grad(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """(loss, grads): the loss over the cast masters and its gradient
    for each master, as a tree shaped like ``params``."""
    leaves = [p for _, p in named_leaves(params)]
    with _spmd_context(leaves):
        loss = loss_fn(cast_params(params, cfg), batch, cfg)
        grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def _spmd_context(leaves):
    """Implicit replication of plain tensors when the masters are
    DTensors; nothing otherwise."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    if any(isinstance(p, DTensor) for p in leaves):
        return implicit_replication()
    return contextlib.nullcontext()


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``lr`` and ``grad_norm``; the
    masters and the optimizer state are updated in place."""

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch, cfg)
        with _spmd_context([g for _, g in named_leaves(grads)]):
            params, opt_state, metrics = adamw_update(params, grads,
                                                      opt_state, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _data_groups(mesh, data_axes: Tuple[str, ...]):
    from ..launch.mesh import device_mesh

    dm = device_mesh(mesh)
    return [dm.get_group(ax) for ax in data_axes]


def compress_and_reduce(g: torch.Tensor, err: torch.Tensor, groups
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(reduced f32 gradient, next error feedback): ``g + err`` rounded
    to bf16, averaged over each process group in bf16 — a SUM all-reduce
    then a division by the group's size, both in bf16, which is the JAX
    package's bf16 ``pmean`` (gloo has no AVG) — and cast back to f32;
    the rounding residual is the next step's feedback term."""
    import torch.distributed as dist

    g = g.to(torch.float32) + err
    g16 = g.to(torch.bfloat16)
    new_err = g - g16.to(torch.float32)
    for group in groups:
        dist.all_reduce(g16, op=dist.ReduceOp.SUM, group=group)
        g16 = g16 / torch.tensor(dist.get_world_size(group),
                                 dtype=torch.bfloat16, device=g16.device)
    return g16.to(torch.float32), new_err


def make_compressed_train_step(cfg: ArchConfig, opt_cfg: OptConfig,
                               mesh, data_axes: Tuple[str, ...]
                               ) -> Callable:
    """Gradient-compressed data-parallel step, run by every SPMD rank
    of ``mesh`` (a port Mesh; :func:`launch.mesh.spawn` sets up the
    world) on its own slice of the batch with replicated plain-tensor
    masters.

    Per-rank f32 grads + carried error feedback (``opt_state["err"]``)
    are quantized to bf16, all-reduced across the data axes in bf16
    (half the bytes), then de-quantized; the quantization residual
    becomes the next step's feedback term.
    """
    groups = _data_groups(mesh, tuple(data_axes))

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch, cfg)
        err = opt_state.get("err")
        if err is None:
            err = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params)
        pairs = [compress_and_reduce(g, e, groups) for (_, g), (_, e)
                 in zip(named_leaves(grads), named_leaves(err))]
        reduced = iter([r for r, _ in pairs])
        residual = iter([e for _, e in pairs])
        grads = tree_map(lambda _: next(reduced), params)
        new_err = tree_map(lambda _: next(residual), params)
        params, new_state, metrics = adamw_update(
            params, grads, {k: v for k, v in opt_state.items()
                            if k != "err"}, opt_cfg)
        new_state["err"] = new_err
        metrics["loss"] = loss
        return params, new_state, metrics

    return train_step


def init_train_state(cfg: ArchConfig, params) -> Dict[str, Any]:
    """The optimizer state a step starts from, under the JAX package's
    name and signature."""
    return init_opt_state(params)

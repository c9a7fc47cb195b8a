"""Sharding rules: logical parameter axes -> mesh axes.

The JAX package's ``launch/sharding.py`` on torch.  Parameters carry
logical axes from their ParamSpec (("embed", "ffn"), ("experts",
"embed", "ffn"), ...).  Rules map logical names to mesh axes per
arch/cell:

  * TP: heads / ffn / vocab / experts -> "model"
  * DP: batch -> ("pod", "data")
  * FSDP (MoE giants, cfg.fsdp_params): the weights' "embed" axis ->
    "data" (ZeRO-3: params + optimizer state sharded; gathered on use)
  * SP (long_500k): the KV/state cache sequence dim -> "data"

Every assignment is guarded by divisibility-or-large (dim >= axis
size); an axis is used at most once per spec.

A :class:`NamedSharding` holds a mesh and a spec: a tuple with one
entry per tensor dim, each ``None`` (replicated), an axis name, or a
tuple of axis names, as ``jax.sharding.PartitionSpec`` does.
:func:`placements` turns it into the ``DTensor`` placements an SPMD
rank uses.  The port's trees differ from the JAX package's in one
place: a model's pattern repeats are a list (``scan``) of per-repeat
trees, not one tree stacked on a leading layers dim, so a scanned leaf's
spec here is the JAX package's without its leading ``None``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..models.common import ParamSpec, map_specs
from ..models.config import ArchConfig
from ..models.model import ShapeCell
from .mesh import Mesh

Spec = Tuple


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a per-dim spec of mesh-axis names."""
    mesh: Mesh
    spec: Spec = ()

    def __post_init__(self):
        object.__setattr__(self, "spec", tuple(self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(sharding: NamedSharding) -> tuple:
    """The DTensor placements of ``sharding``, one per mesh dim:
    ``Shard(i)`` where tensor dim ``i`` is split over that mesh axis,
    ``Replicate()`` elsewhere.  A tensor dim split over several axes is
    split in the spec's order (the first axis outermost), as DTensor
    reads placements in mesh-dim order; a spec that lists its axes out
    of mesh order cannot be expressed and raises ValueError."""
    from torch.distributed.tensor import Replicate, Shard

    names = sharding.mesh.axis_names
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(sharding.spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} lists mesh axes out of "
                             f"mesh order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def logical_rules(cfg: ArchConfig, mesh: Mesh) -> Dict[str, tuple]:
    batch = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    rules: Dict[str, tuple] = {
        "batch": batch,
        "vocab": ("model",),
        "heads": ("model",),
        "ffn": ("model",),
        "experts": ("model",),
        "embed": ("data",) if cfg.fsdp_params else (),
        "layers": (),
        "seq": (),
    }
    return rules


def _spec_for(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
              rules: Dict[str, tuple], mesh: Mesh) -> Spec:
    used = set()
    out = []
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    for dim, name in zip(shape, logical):
        axes = rules.get(name, ()) if name else ()
        chosen = []
        prod = 1
        for ax in axes:
            if ax in used or ax not in sizes:
                continue
            # argument shardings require exact divisibility (e.g.
            # internvl2's vocab 92553 cannot shard 16-way; a production
            # deployment would pad the vocab — we keep the assignment's
            # exact config and replicate instead)
            if dim % (sizes[ax] * prod) == 0:
                chosen.append(ax)
                used.add(ax)
                prod *= sizes[ax]
        if not chosen:
            out.append(None)
        elif len(chosen) == 1:
            out.append(chosen[0])
        else:
            out.append(tuple(chosen))
    return tuple(out)


def param_shardings(specs_tree, cfg: ArchConfig, mesh: Mesh):
    """Tree of NamedShardings matching the ParamSpec tree."""
    rules = logical_rules(cfg, mesh)

    def one(s: ParamSpec):
        return NamedSharding(mesh, _spec_for(s.shape, s.logical_axes,
                                             rules, mesh))

    return map_specs(specs_tree, one)


def opt_state_shardings(param_sh, step_leaf_mesh: Mesh):
    """m/v mirror the params; the step counter is replicated."""
    return {
        "m": param_sh,
        "v": param_sh,
        "step": NamedSharding(step_leaf_mesh, ()),
    }


def _tree_map(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts / lists whose leaves are
    anything with a ``shape`` (tensors, arrays, shape stand-ins)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def batch_shardings(cfg: ArchConfig, cell: ShapeCell, mesh: Mesh,
                    abstract_batch) -> dict:
    """Inputs: shard dim 0 (batch) over (pod, data); long-context decode
    with batch=1 falls back to replication (the cache carries SP)."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n_batch = int(np.prod([sizes[a] for a in batch_axes]))

    def one(_, a):
        shape = tuple(a.shape)
        if len(shape) >= 1 and shape[0] % n_batch == 0 and shape[0] > 1:
            return NamedSharding(mesh, (batch_axes,))
        return NamedSharding(mesh, ())

    return _tree_map(one, abstract_batch)


def cache_shardings(cfg: ArchConfig, cell: ShapeCell, mesh: Mesh,
                    abstract_cache, kv_seq_model: bool = False):
    """Decode-cache sharding, keyed on the cache-leaf names:

      k/v     GQA KV (B, H, S, D)  -> batch->(pod,data), H->model;
                                      batch=1 (long_500k) -> S->data (SP)
      ckv,
      k_rope  MLA latent (B, S, r) -> batch->(pod,data) or S->data (SP)
      conv,
      ssm     (B, d, k)            -> batch, d->model
      h       (B, d)               -> batch, d->model

    The port's ``scan`` caches are a list over repeats, so every leaf
    has its block's own shape (no leading layers dim to replicate).
    """
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n_batch = int(np.prod([sizes[a] for a in batch_axes]))
    n_model = sizes.get("model", 1)
    data_only = tuple(a for a in batch_axes if a == "data")

    def core_spec(name: str, core: Tuple[int, ...]):
        b_ok = core[0] % n_batch == 0 and core[0] > 1
        batch_sp = batch_axes if b_ok else None
        if name in ("k", "v"):                      # (B, H, S, D)
            h_ok = core[1] % n_model == 0 and core[1] >= n_model
            s_ok = (not b_ok) and data_only and core[2] % sizes["data"] == 0
            if kv_seq_model and not h_ok and core[2] % n_model == 0:
                # MQA/kv=1 archs: heads can't split — sequence-shard
                # the cache over the model axis (distributed
                # flash-decode; partial softmax + small reduce)
                return (batch_sp, None, "model", None)
            return (batch_sp, "model" if h_ok else None,
                    data_only if s_ok else None, None)
        if name in ("ckv", "k_rope"):               # (B, S, r)
            s_ok = (not b_ok) and data_only and core[1] % sizes["data"] == 0
            return (batch_sp, data_only if s_ok else None, None)
        if name in ("conv", "ssm"):                 # (B, d, k)
            d_ok = core[1] % n_model == 0
            return (batch_sp, "model" if d_ok else None, None)
        if name == "h":                             # (B, d)
            d_ok = core[1] % n_model == 0
            return (batch_sp, "model" if d_ok else None)
        return tuple(None for _ in core)

    def one(path, a):
        return NamedSharding(mesh, core_spec(path[-1], tuple(a.shape)))

    return _tree_map(one, abstract_cache)



def _distribute(distribute_tensor, t, dm, pl):
    """Each rank keeps its own block of its own full copy (no scatter
    from rank 0: every rank holds the same values, and gloo scatters no
    CUDA tensors); older torch, without ``src_data_rank``, does that
    by default."""
    try:
        return distribute_tensor(t, dm, pl, src_data_rank=None)
    except TypeError:
        return distribute_tensor(t, dm, pl)


def device_put(tree, shardings, dmesh=None):
    """Each tensor of ``tree`` (dicts, lists, ParamTrees) as a DTensor
    placed by the matching NamedSharding of ``shardings`` (a tree with
    the same keys, or one NamedSharding for every leaf) on the
    ``DeviceMesh`` of this SPMD rank (``mesh.device_mesh`` of the
    shardings' mesh by default).  Every rank passes the same full
    tensors and keeps its own shard of each, with no communication;
    ``requires_grad`` carries over.  The ``jax.device_put(tree, shardings)`` of the JAX package's
    SPMD tests."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from ..models.common import ParamTree, children
    from .mesh import device_mesh

    meshes = {}

    def put(node, sh):
        if sh is None:
            return node
        if isinstance(node, torch.Tensor):
            dm = dmesh
            if dm is None:
                dm = meshes.get(sh.mesh)
                if dm is None:
                    dm = meshes[sh.mesh] = device_mesh(sh.mesh)
            out = _distribute(distribute_tensor, node.detach(), dm,
                              placements(sh))
            return out.requires_grad_(node.requires_grad)
        sub = (lambda key: sh) if isinstance(sh, NamedSharding) else \
            (lambda key: sh[key] if isinstance(sh, dict) else sh[int(key)])
        mapped = {key: put(child, sub(key)) for key, child in children(node)}
        if isinstance(node, ParamTree):
            return ParamTree(mapped)
        if isinstance(node, dict):
            return mapped
        return list(mapped.values())

    return put(tree, shardings)


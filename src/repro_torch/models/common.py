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

Under :func:`activation_sharding` (a context variable, as in the JAX
package) :func:`constrain` redistributes DTensor activations of an SPMD
rank to the placements the mesh's logical axes name.
"""
from __future__ import annotations

import contextvars
import math
from contextlib import contextmanager
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


def abstract_params(specs: SpecTree,
                    dtype: Optional[torch.dtype] = None) -> Dict:
    """Shape and dtype stand-ins of the parameters, as the JAX package's
    ``abstract_params`` gives ``ShapeDtypeStruct``s: one tensor on the
    ``meta`` device a leaf, which allocates nothing.  By default each
    leaf has its spec's dtype (f32, training's masters); with ``dtype``
    the storage dtypes serving keeps (:func:`storage_dtype`)."""
    def one(s: ParamSpec) -> torch.Tensor:
        dt = getattr(torch, s.dtype) if dtype is None \
            else storage_dtype(s, dtype)
        return torch.empty(s.shape, dtype=dt, device="meta")

    return map_specs(specs, one)


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


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over (B, T, V) logits and (B, T) int labels, f32 math."""
    lf = logits.float()
    if _is_dtensor(lf):
        # vocab-sharded logits (vocab parallelism): the max, the sum of
        # exponentials and the gold logit (a masked sum, exact: one
        # nonzero term) each reduce over the vocab slices with one
        # all-reduce, and the logits are never gathered
        top = lf.detach().amax(dim=-1, keepdim=True)
        total = torch.exp(lf - top).sum(-1)
        if _rows_over_several_dims(total):
            # summed whole at once: left partial, DTensor reduce-scatters
            # it over the tokens, the logits' gradient comes back split
            # over the tokens, and the unembedding's gradient flattens
            # (B, T) into a token split whose offsets DTensor reads from
            # a tensor, which a fake tensor cannot give
            total = reduce_partial(total)
        lse = torch.log(total) + top[..., 0]
        vocab = torch.arange(lf.shape[-1], device=labels.device)
        hit = (vocab == labels.long()[..., None]).to(lf.dtype)
        gold = (lf * hit).sum(-1)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def shard_activation(x: torch.Tensor, spec, enabled: bool) -> torch.Tensor:
    """``x`` redistributed to the port ``NamedSharding`` spec ``spec``
    when ``enabled`` and ``x`` is a DTensor; ``x`` itself otherwise
    (meshless execution)."""
    if not enabled or not _is_dtensor(x):
        return x
    from ..launch.sharding import NamedSharding, placements

    mesh = _ACT_CTX.get()["mesh"] if _ACT_CTX.get() else None
    if mesh is None:
        raise ValueError("shard_activation needs an activation_sharding "
                         "context naming the mesh")
    return x.redistribute(x.device_mesh,
                          placements(NamedSharding(mesh, tuple(spec))))


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor holding partial sums (an embedding lookup in a
    vocab-split table, a row-parallel product) summed over those mesh
    dims now; anything else as it is."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate

    pls = [Replicate() if isinstance(pl, Partial) else pl
           for pl in x.placements]
    return x if pls == list(x.placements) else \
        x.redistribute(x.device_mesh, pls)


def split_by_rows_only(x: torch.Tensor) -> torch.Tensor:
    """A DTensor (B, ...) kept split along its rows (the batch) only:
    every other placement (a partial sum, a split of the tokens or of
    the features) made whole, as a tensor-parallel block takes its
    input; anything else as it is."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    pls = [pl if pl == Shard(0) else Replicate() for pl in x.placements]
    return x if pls == list(x.placements) else \
        x.redistribute(x.device_mesh, pls)


def with_grad(x: torch.Tensor, fn) -> torch.Tensor:
    """``x`` itself, whose gradient passes through ``fn`` on its way to
    the operation that made ``x``."""
    return _WithGrad.apply(x, fn)


class _WithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def rows_flattened(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` (rows * T, d), flattened from (rows, T, d), itself; where
    DTensor hands its gradient back split along dim 0 over more ranks
    than ``rows`` divides into, the gradient takes ``x``'s own
    placements first.  The products and gathers that read a stream split
    over ``pod`` and ``data`` give it a gradient also split over
    ``model``, which the flattening's backward cannot view as rows: 256
    rows do not split 512 ways.  A plain tensor as it is."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard

    mesh, pls = x.device_mesh, tuple(x.placements)

    def placed(g):
        ranks = math.prod(mesh.size(i) for i, pl in enumerate(g.placements)
                          if pl == Shard(0))
        return g if rows % ranks == 0 else g.redistribute(mesh, pls)

    return with_grad(x, placed)


def grad_by_rows_only(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; under autograd, where DTensor ``x`` is split along
    its rows by more than one mesh dim (``pod`` and ``data``), its
    gradient is split by rows only (:func:`split_by_rows_only`) before
    it reaches the product that made ``x``.  Normed and projected, that
    gradient comes back split through the tokens over ``model`` too,
    which the product's weight gradient flattens with the rows into a
    split whose offsets DTensor reads from a tensor, and a fake tensor
    cannot give them.  Elsewhere ``x`` as it is."""
    if not (_is_dtensor(x) and torch.is_grad_enabled()
            and _rows_over_several_dims(x)):
        return x
    return with_grad(x, split_by_rows_only)


def _rows_over_several_dims(x) -> bool:
    """Whether DTensor ``x`` is split along its rows (the batch) by more
    than one mesh dim (``pod`` and ``data``)."""
    from torch.distributed.tensor import Shard

    return sum(pl == Shard(0) for pl in x.placements) > 1


def settle_residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream between blocks.  Under autograd, on a mesh
    that splits the batch over more than one dim (``pod`` and ``data``),
    a DTensor stream is made whole but for its rows
    (:func:`split_by_rows_only`): the blocks leave it a partial sum under
    autograd (:func:`reduce_row_parallel`), DTensor then sums it into a
    split of the tokens, a later product flattens that with the rows
    into a split whose offsets DTensor reads from a tensor, and a fake
    tensor cannot give them.  Elsewhere ``x`` as it is."""
    if not (_is_dtensor(x) and torch.is_grad_enabled()
            and _rows_over_several_dims(x)):
        return x
    return split_by_rows_only(x)


def reduce_row_parallel(x: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel product (attention's and the dense
    FFN's output projections), summed at once when no gradient is
    recorded (prefill and decode), as tensor parallelism all-reduces
    after such a layer: left partial, it reaches the residual stream and
    the norms, where DTensor picks its own reductions and, at 32K-token
    prompts, splits the tokens in a way it then cannot multiply on fake
    tensors.  Under autograd it stays partial: the backward of the eager
    sum hands the head merge a gradient split through heads."""
    return x if torch.is_grad_enabled() else reduce_partial(x)


def replica_plan(n_kv: int, group: int, n: int) -> Optional[Tuple[int, int,
                                                                   int]]:
    """(r, d, c) for a mesh dim of ``n`` ranks over ``n_kv`` kv heads of
    ``group`` q heads each, where n is a multiple of n_kv: r ranks share
    each kv head, d = gcd(group, r) parts of its q heads, c = r / d
    shards of its keys (rank j: kv head j // r, q part (j % r) // c,
    shard j % c); None where n is not a multiple of n_kv."""
    if n % n_kv:
        return None
    r = n // n_kv
    d = math.gcd(group, r)
    return r, d, r // d


def shard_range(x, dim: int) -> Tuple[int, int]:
    """(first index, length) of this rank's block of DTensor ``x`` along
    tensor dim ``dim``, from its ``Shard`` placements in mesh-dim order
    (``torch.chunk``'s split, as DTensor's): plain integers, which a
    trace on fake tensors can read."""
    from torch.distributed.tensor import Shard

    mesh, begin, size = x.device_mesh, 0, x.shape[dim]
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            chunk = -(-size // mesh.size(i))
            lo = min(mesh.get_local_rank(i) * chunk, size)
            begin, size = begin + lo, min(size - lo, chunk)
    return begin, size


# ---------------------------------------------------------------------------
# activation-sharding context (constrains DTensor activations)
# ---------------------------------------------------------------------------
_ACT_CTX = contextvars.ContextVar("repro_torch_act_sharding", default=None)


@contextmanager
def activation_sharding(mesh, **logical_axes):
    """Context: ``constrain(x, ("tokens", None))`` redistributes a
    DTensor ``x`` to the placements of ``NamedSharding(mesh,
    (axes["tokens"], None))`` — a no-op outside the context and on
    plain tensors, so single-device paths are untouched.  ``mesh`` is a
    port :class:`~repro_torch.launch.mesh.Mesh`.

    logical_axes example: tokens=("pod","data"), experts="model",
    model="model"; ``moe_ep=(token_axes, model_axis)`` routes MoE FFNs
    through the expert-parallel ``ffn.moe_forward_ep``.
    """
    token = _ACT_CTX.set({"mesh": mesh, "axes": logical_axes})
    try:
        yield
    finally:
        _ACT_CTX.reset(token)


def constrain(x: torch.Tensor, dims: Tuple[Optional[str], ...]
              ) -> torch.Tensor:
    """Constrain each dim to the mesh axes bound to its logical name."""
    ctx = _ACT_CTX.get()
    if ctx is None or not _is_dtensor(x):
        return x
    mesh = ctx["mesh"]
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    spec = []
    used = set()
    for dim, name in zip(x.shape, dims):
        ax = ctx["axes"].get(name) if name else None
        if ax is None:
            spec.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        prod = 1
        for a in axes:
            prod *= sizes[a]
        if axes and dim % prod == 0:
            spec.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            spec.append(None)
    return shard_activation(x, spec, True)

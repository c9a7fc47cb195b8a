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
rank to the placements the mesh's logical axes name.  On such a rank
:func:`copy_to_model` and :func:`reduce_from_model` (tensor
parallelism's pair of autograd regions) keep the residual stream split
by rows only, in the forward and the backward.
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
        lse, gold = _vocab_parallel_terms(lf, labels)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _vocab_parallel_terms(lf, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-sum-exp, gold logit) of DTensor f32 logits (B, T, V), read
    where they lie (vocab parallelism): each rank takes the max, the sum
    of exponentials and the gold logit (a masked sum, exact: one nonzero
    term) of its own vocab slice, and each (B, T) term is summed over
    the slices (:func:`reduce_from_model`); no rank holds the logits of
    the whole vocab, or a one-hot of it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, last = lf.device_mesh, lf.ndim - 1
    top = _placed(lf.detach().amax(dim=-1, keepdim=True), mesh,
                  _rows_only(lf))
    total = reduce_from_model(torch.exp(lf - top).sum(-1))
    begin, n = shard_range(lf, last)
    ids = torch.arange(begin, begin + n, device=labels.device)
    vocab = DTensor.from_local(
        ids, mesh, [Shard(0) if pl == Shard(last) else Replicate()
                    for pl in lf.placements],
        run_check=False, shape=(lf.shape[last],), stride=(1,))
    hit = (vocab == labels.long()[..., None]).to(lf.dtype)
    gold = reduce_from_model((lf * hit).sum(-1))
    return torch.log(total) + top[..., 0], gold


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


# ---------------------------------------------------------------------------
# tensor parallelism under autograd (Megatron's pair of regions)
# ---------------------------------------------------------------------------
# On an SPMD rank the residual stream (B, T, d) is split along its rows
# over the batch's mesh dims and whole over every other dim, in the
# forward and in the backward.  A column-parallel product (a weight
# whose columns a mesh dim splits) reads it through copy_to_model; a
# row-parallel product's partial sums join it through reduce_from_model.
# Each sets its gradient's placements itself, so DTensor never picks
# them: a gradient left partial, or split along the tokens or features,
# makes DTensor gather weights and multiply whole products on every
# rank, and split the tokens in ways it cannot then view as rows.
def _rows_only(x) -> list:
    """DTensor ``x``'s placements with its rows' split (``Shard(0)``)
    kept and every other placement (a partial sum, a split of the tokens
    or of the features) made whole."""
    from torch.distributed.tensor import Replicate, Shard

    return [pl if pl == Shard(0) else Replicate() for pl in x.placements]


def _placed(x, mesh, pls) -> torch.Tensor:
    """DTensor ``x`` redistributed to ``pls``; ``x`` itself where it is
    placed so already."""
    pls = tuple(pls)
    return x if tuple(x.placements) == pls else x.redistribute(mesh, pls)


class _ReduceFromModel(torch.autograd.Function):
    """Forward: ``x`` whole but for its rows (partial sums summed over
    the mesh dims that split a contraction: an all-reduce).  Backward:
    the gradient handed on as it is, whole but for its rows: the
    gradient of each rank's partial term is the whole gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.pls = x.device_mesh, _rows_only(x)
        out = _placed(x, ctx.mesh, ctx.pls)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return _placed(g, ctx.mesh, ctx.pls)


class _CopyToModel(torch.autograd.Function):
    """Forward: ``x`` itself, which every rank of a mesh dim reads for
    its own slice of a column-parallel product.  Backward: the
    gradient's partial sums over those ranks summed (an all-reduce), so
    that it is placed as ``x`` was."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.pls = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _placed(g, ctx.mesh, ctx.pls)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """A DTensor (the output of a row-parallel product, an embedding
    lookup in a vocab-split table, a term of the vocab-parallel loss)
    made whole but for its rows: its partial sums summed, as tensor
    parallelism all-reduces after such a layer.  Anything else as it
    is."""
    if not _is_dtensor(x):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x)
    return _placed(x, x.device_mesh, _rows_only(x))


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x``, the input of column-parallel products; under autograd a
    DTensor's gradient is summed over the ranks that split those
    products and placed as ``x`` is.  Anything else as it is."""
    if _is_dtensor(x) and torch.is_grad_enabled() and x.requires_grad:
        return _CopyToModel.apply(x)
    return x


def gathered_on_use(w: torch.Tensor) -> torch.Tensor:
    """Under autograd, DTensor weight ``w`` with every split over a mesh
    dim that also splits the batch ("pod", "data": FSDP's split of the
    "embed" axis) gathered, as ZeRO-3 gathers a weight where it is used;
    its gradient comes back summed and split as ``w`` is.  The head
    takes it: left to itself, DTensor kept the head's contraction split
    over "data" and summed partial logits of every row and the whole
    vocab there.  Forward-only routes (prefill, decode, whose few rows'
    partial logits move less than the weight) and plain tensors are left
    as they are."""
    if not (_is_dtensor(w) and torch.is_grad_enabled() and w.requires_grad):
        return w
    from torch.distributed.tensor import Replicate, Shard

    names = w.device_mesh.mesh_dim_names
    return _placed(w, w.device_mesh, [
        Replicate() if isinstance(pl, Shard) and names[i] in ("pod", "data")
        else pl for i, pl in enumerate(w.placements)])


def row_parallel(h: torch.Tensor, w: torch.Tensor,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h @ w`` for a weight whose rows (the contraction) a mesh dim
    splits: attention's and the dense FFN's output projections, MLA's,
    Mamba's ``x_proj`` and ``out_proj``, RG-LRU's ``out``; reduced
    (:func:`reduce_from_model`), or with ``rows`` (a decode step, no
    gradient) summed to ``rows``'s row split (:func:`summed_to_rows`).
    On DTensors ``h`` is first split along its last dim as ``w``'s rows
    are (a slice of what a rank holds), through an autograd
    redistribute, so that its gradient comes back placed as ``h`` was
    (llama4-scout's 40 heads do not split 16 ways, and the merged heads'
    gradient could not be viewed as heads)."""
    if _is_dtensor(h):
        from torch.distributed.tensor import Shard

        h = _placed(h, h.device_mesh,
                    [Shard(h.ndim - 1) if wp == Shard(0) else hp
                     for hp, wp in zip(h.placements, w.placements)])
    if rows is not None:
        return summed_to_rows(h @ w, rows)
    return reduce_from_model(h @ w)


def summed_to_rows(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """DTensor ``y``, a product of a decode step's stream ``x`` (no
    gradient), whole but for ``x``'s row split: its partial sums summed
    into ``x``'s rows (a reduce-scatter where a mesh dim splits both the
    rows and the contraction, as FSDP's "data" does), and any other split
    gathered.  DTensor resolves FSDP's split of a weight by moving the
    rows to a split of d, so the product holds every row of the step;
    :func:`reduce_from_model` would keep them all.  Anything else as it
    is."""
    if not _is_dtensor(y):
        return y
    return _placed(y, y.device_mesh, _rows_only(x))


def model_rows_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a decode step's stream ``x`` (N, ..., d) (no
    gradient; split by rows only) and a weight ``w`` (d, r) whose rows
    FSDP splits over one mesh dim ("data") and whose columns no mesh dim
    splits: MLA's latent down-projections and the MoE router.  Placed as
    :func:`summed_to_rows` places it.

    Each rank multiplies 1 / (n_data n_model) of the step's product, as
    in the JAX package's partitioned HLO, where each "model" rank
    contracts its own rows over a share of d (a collective-permute of
    the weight's block) and the partial sums are all-reduced over
    "model".  Here no weight moves: DTensor moves the stream to a split
    of d over "data" (an all-to-all), each "model" rank multiplies its
    share of those rows over its "data" rank's block of d, the partial
    sums are all-reduced over "data" in f32, as that HLO all-reduces
    them, and rounded once to ``x``'s dtype, as the single device's
    product is, and an all-reduce over "model", to
    which one rank brings each row, hands every rank its own rows.
    Where no mesh dim splits ``w``'s rows, or no "model" dim repeats the
    product (``heads_mesh_dim``), :func:`summed_to_rows` of the product,
    which no rank then repeats."""
    if not _is_dtensor(x):
        return x @ w
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = x.device_mesh
    split = [i for i, pl in enumerate(w.placements)
             if pl == Shard(0) and mesh.size(i) > 1]
    model = heads_mesh_dim(mesh)
    if not split or model is None or mesh.size(model) == 1:
        return summed_to_rows(x @ w, x)
    data, = split
    rows = _rows_only(x)
    if tuple(x.placements) != tuple(rows) or rows[model] != Replicate() \
            or any(pl != Replicate() for i, pl in enumerate(w.placements)
                   if i != data):
        raise ValueError(f"model_rows_product: stream {x.placements}, "
                         f"weight {w.placements} on {mesh}")
    # the rows of the "data" group (all of them where "data" does not
    # split the batch), each rank's block of d
    xt = x.redistribute(mesh, [Shard(x.ndim - 1) if i == data else pl
                               for i, pl in enumerate(rows)])
    group_lo, group_n = shard_range(xt, 0)
    own_lo, own_n = shard_range(x, 0)
    own_lo -= group_lo
    n_m, m = mesh.size(model), mesh.get_local_rank(model)
    chunk = -(-group_n // n_m)
    lo, hi = min(m * chunk, group_n), min((m + 1) * chunk, group_n)
    part = xt.to_local()[lo:hi].float() @ w.to_local().float()
    part = _ready(funcol.all_reduce(part, "sum", (mesh, data))).to(x.dtype)
    out = part.new_zeros((own_n,) + tuple(part.shape[1:]))
    a, b = max(lo, own_lo), min(hi, own_lo + own_n)
    if a < b:
        out[a - own_lo:b - own_lo] = part[a - lo:b - lo]
    out = _ready(funcol.all_reduce(out, "sum", (mesh, model)))
    shape = tuple(x.shape[:-1]) + (w.shape[-1],)
    return DTensor.from_local(out, mesh, rows, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, step = [], 1
    for n in reversed(shape):
        stride.append(step)
        step *= n
    return tuple(reversed(stride))


def _ready(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor

    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def settle_residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream between blocks, on a DTensor rank: whole but
    for its rows, and its gradient too (:func:`reduce_from_model`),
    in training as in prefill and decode."""
    return reduce_from_model(x)


def heads_mesh_dim(mesh) -> Optional[int]:
    """The dim of DeviceMesh ``mesh`` that the JAX package's rules give
    the attention heads ("model", ``launch.sharding.logical_rules``), or
    None on a mesh with no such dim.  The sharded attention routes split
    the heads, and share a kv head's replica, over that dim only; a
    batch dim the batch leaves free ("pod", "data") replicates them."""
    names = mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def batch_mesh_dims(mesh, batch: int) -> List[int]:
    """The dims of DeviceMesh ``mesh`` that the JAX package's rules give
    a batch of ``batch`` rows (``launch.sharding.logical_rules``:
    "batch" over ("pod", "data"), each dim in mesh order where the
    product of the dims taken so far and its own size divides the
    batch, as ``_spec_for`` guards an argument's split), leaving out a
    dim of one rank, whose split would split nothing."""
    names = mesh.mesh_dim_names or ()
    out, prod = [], 1
    for i, name in enumerate(names):
        if name in ("pod", "data") and mesh.size(i) > 1 \
                and batch % (prod * mesh.size(i)) == 0:
            out.append(i)
            prod *= mesh.size(i)
    return out


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

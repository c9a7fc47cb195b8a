"""Multi-pod dry run: every (arch x shape x mesh) cell's step traced at
its production size on fake tensors, in one CPU process, with no card.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell on
256 / 512 forced XLA host devices and reads flops, bytes and collectives
from the compiled module.  Here one process plays rank 0 of a fake
world:

  * a fake process group (``torch.testing._internal.distributed.fake_pg``,
    backend ``"fake"``) of 256 ranks (``pod16x16``) or 512
    (``pod2x16x16``), and the port's production mesh over it
    (``make_production_mesh(devices=[...] * n)``, ``device_mesh``);
  * under a ``FakeTensorMode``, parameters, optimizer state, batch and
    cache are fake tensors (shapes, no storage; ``cuda`` ones where torch
    is built with CUDA, see :func:`fake_device_type`), each a DTensor
    built from rank 0's shard (``DTensor.from_local``) as the port's
    ``param_shardings`` / ``opt_state_shardings`` / ``batch_shardings``
    / ``cache_shardings`` place it;
  * the cell's step runs eagerly, as on the card: ``train`` is
    ``make_train_step(cfg, OptConfig())``, ``prefill`` is ``forward``
    without gradients, ``decode`` is one ``decode_step`` against a
    ``seq_len`` cache at
    ``cur_len = seq_len - 1``, a full cache (the decode kernel's flop
    formula counts every cache slot, which is the work at a full cache).

The attention kernels are reached as on the card, through their custom
operators (``torch.ops.repro_torch.flash_attention`` /
``decode_attention``), which fake tensors take on any device and whose
fake implementations return empty outputs of the right shape; their
flop formulas count the attention.  The Mamba and RG-LRU time scans are
custom operators too (``torch.ops.repro_torch.ssm_scan`` /
``rglru_scan`` and their backwards, ``models/scan_ops.py``), so that a
trace dispatches one op a layer where the plain loop dispatches a few
a time step (32,768 steps at ``prefill_32k``); each rank scans its
local rows and channels, with no collective.

What :class:`StepCounter` counts, per device (rank 0's local shards):

  * ``flops_per_device``: the flops of every op that runs on a local
    shard, by ``torch.utils.flop_counter``'s formulas (the ones
    ``FlopCounterMode`` uses, which count matrix products, convolutions
    and attention; elementwise work is not counted).  ``FlopCounterMode``
    itself, run over DTensors, counts each op once at its global shape;
    the counter lets DTensor first turn an op into its local ops and
    collectives and counts those, so the figure is what one rank
    computes, redundant work on replicated dims included.
  * ``bytes_accessed_per_device``: for each local op, its tensor inputs
    read once and its outputs written once (views, allocations and
    waits move nothing; an argument the op writes counts as output).
  * collectives: each functional collective's result bytes, summed by
    ``roofline.collective_bytes_from_ops`` under the JAX package's op
    names, and the largest of each op (``collective_largest``: an
    all-gather as large as a cache or table shard is one that gathers
    it).  DTensor's shard-to-shard redistribution counts as the
    all-to-all a card's process group runs (:func:`fake_world`); the
    MoE layer's all-to-alls move the rows of a balanced route, as a
    fake route has no values (:func:`_balanced_moe_route`; each MoE
    report says so under ``moe_route``).  Every
    layer is counted, so the totals compare with the JAX package's
    ``collective_bytes_per_device``, not with its per-op dict, which
    counts a scanned layer body once.
  * ``memory.peak_bytes_per_device_est``: the high-water mark of the
    live bytes of rank 0's storages (inputs, and every op's outputs
    until they are freed); an estimate, as the JAX package's is.

The JAX package corrects XLA's cost analysis, which counts a while-loop
body once, with ``_scan_body_probe``.  An eager trace runs every layer,
so there is no probe and no ``flops_raw_hlo`` / ``scan_body_probe`` in
the report.

The fake process group belongs to the process: run the module as the
entry point of a process of its own (``python -m
repro_torch.launch.dryrun``); :func:`run_cell` starts the group and
destroys it when it returns.  Reports go to ``reports/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback
import weakref
from contextlib import ExitStack, contextmanager
from dataclasses import replace as dc_replace
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import get_config, list_configs
from ..models.common import ParamTree, abstract_params, activation_sharding
from ..models.config import ArchConfig
from ..models.decoder import init_cache
from ..models.model import (SHAPES, ShapeCell, decode_step, forward,
                            get_shape, input_specs, model_specs)
from ..models.scan_ops import OPERATORS as SCAN_OPERATORS
from ..train.optimizer import OptConfig
from ..train.train_step import make_train_step
from .mesh import Mesh, device_mesh, make_production_mesh
from .roofline import (COLLECTIVE_OPS, collective_bytes_from_ops,
                       roofline_terms)
from .sharding import (NamedSharding, batch_shardings, cache_shardings,
                       opt_state_shardings, param_shardings, placements)

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")

# the card the roofline terms are read for
DEVICE = "NVIDIA H100 80GB HBM3"


# long_500k needs sub-quadratic attention: a 524,288-token cache is
# skipped for the archs whose every attention layer is full (quadratic)
LONG_OK = {"falcon-mamba-7b", "recurrentgemma-9b", "gemma3-1b",
           "gemma3-12b"}

# the JAX package's run_cell options this port honours; any other raises
OPTIONS = ("shard_acts", "remat", "capacity_factor", "fsdp", "moe_ep",
           "logits_sharded", "kv_seq_model")


def cell_is_skipped(arch: str, shape: str) -> Optional[str]:
    if shape == "long_500k" and arch not in LONG_OK:
        return "long_500k skipped: pure full-attention arch (quadratic)"
    return None


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------
# metadata queries FlopCounterMode passes over
_METADATA = {torch.ops.aten.sym_is_contiguous.default,
             torch.ops.aten.is_contiguous.default,
             torch.ops.aten.is_contiguous.memory_format,
             torch.ops.aten.is_strides_like_format.default,
             torch.ops.aten.is_non_overlapping_and_dense.default,
             torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
             torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
             torch.ops.aten.storage_offset.default,
             torch.ops.aten.sym_storage_offset.default,
             torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
             torch.ops.aten.dim.default, torch.ops.prim.layout.default}
# allocations without a write: they hold memory and move no bytes
_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.empty_like.default,
                torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts the ops that run on local tensors: flops (by
    ``flop_registry``, decomposing what has no formula as
    ``FlopCounterMode`` does), bytes, functional collectives, calls of
    the port's custom kernels (``kernel_calls``) and of its scan
    operators (``operator_calls``), and live storage bytes.

    An op on DTensors is handed back to DTensor (``NotImplemented``),
    which dispatches its local ops and collectives to this mode again.
    Ops on ``meta`` tensors, and the ops DTensor's sharding propagation
    runs at global shapes to learn an output's shape (see
    :func:`_uncounted_propagation`), are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = []            # (op name, result bytes)
        self.kernel_calls: Dict[str, int] = {}
        self.operator_calls: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self.paused = 0
        self._storages: Dict[int, weakref.ref] = {}

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(_, key=key, n=n):
            self.live -= n
            self._storages.pop(key, None)

        self._storages[key] = weakref.ref(st, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        tensors = [a for a in tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
        if self.paused or func is torch.ops.prim.device.default \
                or any(a.device.type == "meta" for a in tensors):
            return func(*args, **kwargs)
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        for o in outs:
            self.track(o)
        ns = func.namespace
        if ns == "repro_torch":
            name = packet.__name__
            calls = self.operator_calls if name in SCAN_OPERATORS \
                else self.kernel_calls
            calls[name] = calls.get(name, 0) + 1
        if ns == "_c10d_functional":
            if packet.__name__ != "wait_tensor":
                self.collectives.append(
                    (packet.__name__, sum(_nbytes(o) for o in outs)))
            return
        if func.is_view or func in _ALLOCATIONS:
            return
        written = [i for i, a in enumerate(func._schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write]
        read = [a for i, a in enumerate(args) if i not in written]
        read += [v for k, v in kwargs.items()
                 if not any(func._schema.arguments[i].name == k
                            for i in written)]
        self.bytes += sum(_nbytes(t) for t in tree_leaves(read)
                          if isinstance(t, torch.Tensor))
        self.bytes += sum(_nbytes(o) for o in outs)


@contextmanager
def _uncounted_propagation(counter: StepCounter):
    """DTensor learns an op's output shape by running the op on fake
    tensors of the global shapes (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``), in the fake mode this run
    already has; inside the context those calls pause ``counter``.
    Raises when this torch has no such method to wrap."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    real = getattr(ShardingPropagator, name, None)
    if real is None:
        raise RuntimeError(f"torch {torch.__version__}: ShardingPropagator "
                           f"has no {name}; the dry run cannot tell its "
                           f"shape propagation from the step's ops")

    def paused(self, *args, **kwargs):
        counter.paused += 1
        try:
            return real(self, *args, **kwargs)
        finally:
            counter.paused -= 1

    setattr(ShardingPropagator, name, paused)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, real)


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------
@contextmanager
def _shard_to_shard_as_all_to_all():
    """Inside the context, DTensor redistributes Shard(i) to Shard(j)
    over a mesh dim by ``funcol.all_to_all_single``, as it does on a
    card's process group: on a CPU mesh it all-gathers the whole tensor
    and keeps a chunk (and says so in a warning), which the counter
    would book as an all-gather of mesh-size times the bytes.  Raises
    when this torch has no ``shard_dim_alltoall`` to replace."""
    import torch.distributed.tensor._collective_utils as cu
    import torch.distributed.tensor.placement_types as pt
    from torch.distributed import _functional_collectives as funcol

    missing = [m.__name__ for m in (cu, pt)
               if not hasattr(m, "shard_dim_alltoall")]
    if missing:
        raise RuntimeError(f"torch {torch.__version__}: no "
                           f"shard_dim_alltoall in {missing} to count as "
                           f"an all-to-all")

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        # DTensor pads the local shard so that the split dim divides:
        # every rank's block has this rank's block's shape
        n = mesh.size(mesh_dim)
        parts = torch.tensor_split(input, n, dim=shard_dim)
        block = parts[0].shape
        send = torch.cat([p.reshape(-1) for p in parts])
        out = funcol.all_to_all_single(send, [parts[0].numel()] * n,
                                       [p.numel() for p in parts],
                                       (mesh, mesh_dim))
        if isinstance(out, funcol.AsyncCollectiveTensor):
            out = out.wait()
        return torch.cat([b.view(block) for b in out.split(
            parts[0].numel())], dim=gather_dim)

    saved = [(m, m.shard_dim_alltoall) for m in (cu, pt)]
    for m, _ in saved:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m, fn in saved:
            m.shard_dim_alltoall = fn


def _balanced_pair_counts(r, e: int, lo: int, n_e: int, rows, caps
                          ) -> list:
    """``models/ffn.py::_pair_counts`` for a fake route, which has no
    values: the counts of a balanced route (entry ``t * k + c`` to
    expert ``(t * k + c) % E``, which drops none), the traffic of a
    router that spreads its tokens evenly."""
    s, k = r.top_idx.shape
    return _balanced_counts(int(s), int(k), e, r.capacity, lo, n_e,
                            tuple(rows), tuple(caps))


@functools.lru_cache(maxsize=64)
def _balanced_counts(s: int, k: int, e: int, cap: int, lo: int, n_e: int,
                     rows: tuple, caps: tuple) -> list:
    # expert x's r-th entry is entry x + e * r, token (x + e * r) // k
    rank = np.arange(cap)[:, None]
    entry = np.arange(lo, lo + n_e)[None, :] + e * rank
    held = entry < s * k
    src = np.searchsorted([b for b, _ in rows], entry // k, side="right") - 1
    dst = np.searchsorted([b for b, _ in caps], rank, side="right") - 1
    n_t = len(rows)
    key = (src * n_t + np.broadcast_to(dst, entry.shape))[held]
    return np.bincount(key, minlength=n_t * n_t).reshape(n_t, n_t).tolist()


@contextmanager
def _balanced_moe_route():
    """Inside the context the MoE layer's all-to-all split sizes are a
    balanced route's (:func:`_balanced_pair_counts`): a fake route has
    no values to read them from."""
    from ..models import ffn

    real = ffn._pair_counts
    ffn._pair_counts = _balanced_pair_counts
    try:
        yield
    finally:
        ffn._pair_counts = real


@contextmanager
def _meshes_flattened_outside_the_trace():
    """Inside the context a mesh that the step flattens (the MoE layer's
    all-to-alls run over "pod" and "data" flattened) is made outside the
    fake mode and the counter: its tensor of ranks is a real one, and
    making it is not the step's work."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils._python_dispatch import _disable_current_modes

    real = DeviceMesh._flatten

    def flatten(self, *args, **kwargs):
        with _disable_current_modes():
            return real(self, *args, **kwargs)

    DeviceMesh._flatten = flatten
    try:
        yield
    finally:
        DeviceMesh._flatten = real


# a report's note on the MoE layer's all-to-all bytes
BALANCED_ROUTE = ("the MoE layer's all-to-all bytes are a balanced "
                  "router's: entry t * k + c to expert (t * k + c) % E, "
                  "none dropped")


@contextmanager
def fake_world(n_ranks: int):
    """This process as rank 0 of a fake process group of ``n_ranks``,
    where DTensor's shard-to-shard redistributions are all-to-alls
    (:func:`_shard_to_shard_as_all_to_all`); the group is destroyed on
    exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running in this "
                           "process; the dry run needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        with _shard_to_shard_as_all_to_all():
            yield
    finally:
        dist.destroy_process_group()
        _forget_meshes()


def _forget_meshes() -> None:
    """Clears what DTensor caches by mesh: its sharding decisions and
    redistribution plans hold the mesh they were made on, and a mesh of
    the next world in this process equals this one's, so they would hand
    it this world's meshes and, through a flattened mesh (``models/
    ffn.py`` flattens "pod" and "data"), groups that no longer exist."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute as R

    prop = DTensor._op_dispatcher.sharding_propagator
    for clear in (getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                          None),
                  getattr(prop.propagate_op_sharding, "cache_clear", None),
                  getattr(R, "clear_redistribute_planner_cache", None),
                  getattr(getattr(R, "_gen_transform_infos", None),
                          "cache_clear", None)):
        if clear is not None:
            clear()


def fake_device_type() -> str:
    """The device of the fake tensors: ``cuda`` on a torch built with
    CUDA.  A torch built without it has no device guard for ``cuda``,
    which autograd and Python indexing set up before they dispatch, so
    there the fakes are ``cpu`` tensors; the kernel wrappers trace their
    custom operators for a fake tensor of either device."""
    return "cpu" if torch.version.cuda is None else "cuda"


def fake_dtensor(meta: torch.Tensor, sharding: NamedSharding, dmesh,
                 requires_grad: bool = False):
    """A DTensor of ``meta``'s shape and dtype, placed by ``sharding``,
    whose local shard is a tensor of the active fake mode on the mesh's
    device.  Raises ValueError for a split that does not divide a dim."""
    from torch.distributed.tensor import DTensor, Shard

    pls = placements(sharding)
    local = list(meta.shape)
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            n = dmesh.size(i)
            if local[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(meta.shape)} does "
                                 f"not split {n} ways")
            local[pl.dim] //= n
    t = torch.empty(local, dtype=meta.dtype, device=dmesh.device_type)
    out = DTensor.from_local(t, dmesh, pls, run_check=False,
                             shape=meta.shape, stride=meta.stride())
    return out.requires_grad_(requires_grad)


def _place(tree, shardings, dmesh, requires_grad: bool = False):
    """``fake_dtensor`` over matching trees (dicts / lists) of meta
    tensors and NamedShardings."""
    if isinstance(tree, torch.Tensor):
        return fake_dtensor(tree, shardings, dmesh, requires_grad)
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k], dmesh, requires_grad)
                for k, v in tree.items()}
    return [_place(v, s, dmesh, requires_grad)
            for v, s in zip(tree, shardings)]


def _locals(tree) -> list:
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
def lower_cell(cfg: ArchConfig, cell: ShapeCell, mesh: Mesh, dmesh,
               logits_sharded: bool = False, kv_seq_model: bool = False):
    """(step function, its fake DTensor arguments) for one cell, built
    under the active ``FakeTensorMode`` on ``dmesh`` (the DeviceMesh of
    ``mesh``)."""
    from torch.distributed.tensor import Replicate, Shard

    specs = model_specs(cfg)
    p_sh = param_shardings(specs, cfg, mesh)

    if cell.step == "train":
        abatch = input_specs(cfg, cell)
        b_sh = batch_shardings(cfg, cell, mesh, abatch)
        f32 = abstract_params(specs)            # masters, m and v
        masters = ParamTree(_place(f32, p_sh, dmesh, requires_grad=True))
        o_sh = opt_state_shardings(p_sh, mesh)
        opt = {"m": ParamTree(_place(f32, o_sh["m"], dmesh)),
               "v": ParamTree(_place(f32, o_sh["v"], dmesh)),
               "step": fake_dtensor(torch.empty((), dtype=torch.int32,
                                                device="meta"),
                                    o_sh["step"], dmesh)}
        step = make_train_step(cfg, OptConfig())
        return step, (masters, opt, _place(abatch, b_sh, dmesh))

    dtype = getattr(torch, cfg.dtype)
    params = _place(abstract_params(specs, dtype), p_sh, dmesh)
    if cell.step == "prefill":
        abatch = input_specs(cfg, cell)
        batch = _place(abatch, batch_shardings(cfg, cell, mesh, abatch),
                       dmesh)

        @torch.no_grad()
        def prefill(params, batch):
            return forward(params, batch["tokens"], cfg,
                           batch.get("prefix_embeds"))

        return prefill, (params, batch)

    # decode: one token against a full seq_len-long cache
    acache = init_cache(cfg, cell.global_batch, cell.seq_len,
                        device="meta")
    cache = _place(acache, cache_shardings(cfg, cell, mesh, acache,
                                           kv_seq_model=kv_seq_model),
                   dmesh)
    atoken = input_specs(cfg, cell)
    token = _place(atoken, batch_shardings(cfg, cell, mesh, atoken),
                   dmesh)["token"]
    cur_len = cell.seq_len - 1
    logit_pl = None
    if logits_sharded:
        # keep the logits vocab-sharded on the way out (sampling runs
        # shard-local), as the JAX package's out_shardings do
        sizes = mesh.shape
        batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
        n_b = 1
        for a in batch_axes:
            n_b *= sizes[a]
        b_ok = cell.global_batch % n_b == 0 and cell.global_batch > 1
        v_ok = cfg.vocab_size % sizes["model"] == 0
        logit_pl = [Shard(0) if a in batch_axes and b_ok else
                    Shard(1) if a == "model" and v_ok else Replicate()
                    for a in mesh.axis_names]

    @torch.no_grad()
    def serve_step(params, cache, token):
        logits, cache = decode_step(params, cache, token, cur_len, cfg)
        if logit_pl is not None:
            logits = logits.redistribute(dmesh, logit_pl)
        return logits, cache

    return serve_step, (params, cache, token)


def _config(arch: str, options: dict) -> ArchConfig:
    unknown = sorted(set(options) - set(OPTIONS))
    if unknown:
        raise ValueError(f"dry-run options {unknown} are not supported by "
                         f"the port (supported: {list(OPTIONS)})")
    cfg = get_config(arch)
    if "remat" in options:
        cfg = dc_replace(cfg, remat=options["remat"])
    if "capacity_factor" in options:
        cfg = dc_replace(cfg, capacity_factor=options["capacity_factor"])
    if "fsdp" in options:
        cfg = dc_replace(cfg, fsdp_params=options["fsdp"])
    return cfg


def trace_step(cfg: ArchConfig, cell: ShapeCell, n_ranks: int,
               make_mesh: Callable[[list], Mesh],
               options: Optional[dict] = None) -> dict:
    """Trace one step of ``cell`` for ``cfg`` as rank 0 of a fake world
    of ``n_ranks``, on the mesh ``make_mesh(devices)`` builds, and return
    rank 0's counts: ``flops``, ``bytes``, ``collectives`` (as
    :func:`~.roofline.collective_bytes_from_ops` gives them),
    ``largest`` (the largest result of each collective op),
    ``kernel_calls``, ``operator_calls``, ``peak_bytes`` and the seconds
    it took to build the fake arguments and to run the step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    options = options or {}
    t0 = time.time()
    with fake_world(n_ranks), ExitStack() as stack:
        mesh = make_mesh([fake_device_type()] * n_ranks)
        dmesh = device_mesh(mesh)
        batch_axes = tuple(a for a in ("pod", "data")
                           if a in mesh.axis_names)
        axes = {}
        if options.get("shard_acts"):
            axes.update(tokens=batch_axes, batch=batch_axes, vocab="model")
            if options["shard_acts"] != "tokens":
                axes["experts"] = "model"
        if options.get("moe_ep"):
            axes["moe_ep"] = (batch_axes, "model")
        if axes:
            stack.enter_context(activation_sharding(mesh, **axes))
        stack.enter_context(_balanced_moe_route())
        stack.enter_context(_meshes_flattened_outside_the_trace())
        stack.enter_context(FakeTensorMode())
        fn, args = lower_cell(
            cfg, cell, mesh, dmesh,
            logits_sharded=bool(options.get("logits_sharded")),
            kv_seq_model=bool(options.get("kv_seq_model")))
        counter = StepCounter()
        for t in _locals(args):
            counter.track(t)
        t_build = time.time() - t0
        with implicit_replication(), counter, \
                _uncounted_propagation(counter):
            out = fn(*args)
        del out, args
    largest: Dict[str, int] = {}
    for name, nbytes in counter.collectives:
        op = COLLECTIVE_OPS.get(name, name)
        largest[op] = max(largest.get(op, 0), nbytes)
    return {"flops": counter.flops, "bytes": counter.bytes,
            "collectives": collective_bytes_from_ops(counter.collectives),
            "largest": largest,
            "kernel_calls": counter.kernel_calls,
            "operator_calls": counter.operator_calls,
            "peak_bytes": counter.peak, "build_seconds": t_build,
            "trace_seconds": time.time() - t0 - t_build}


def run_cell(arch: str, shape: str, multi_pod: bool,
             save: bool = True, variant: str = "",
             options: Optional[dict] = None) -> dict:
    """options (perf-iteration knobs, the JAX package's):
      shard_acts: bool|"tokens" — activation sharding constraints
                                  (tokens/batch/vocab; else also experts)
      moe_ep: bool               — expert-parallel MoE FFNs
      remat: "none"|"block"      — override activation checkpoint policy
      capacity_factor: float     — MoE expert-capacity override
      fsdp: bool                 — override ZeRO-3 param sharding
      logits_sharded: bool       — decode logits stay vocab-sharded
      kv_seq_model: bool         — sequence-shard an unsplittable-head
                                   KV cache over the model axis
    Any other key raises ValueError.
    """
    options = options or {}
    cell = get_shape(shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    result = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "variant": variant or "baseline", "options": options,
              "status": "ok"}
    skip = cell_is_skipped(arch, shape)
    if skip:
        result["status"] = "skipped"
        result["reason"] = skip
        _save(result, save)
        return result

    cfg = _config(arch, options)
    n_chips = 512 if multi_pod else 256
    try:
        counts = trace_step(cfg, cell, n_chips, lambda devices:
                            make_production_mesh(multi_pod=multi_pod,
                                                 devices=devices), options)
        coll = counts["collectives"]
        total, active = cfg.param_count()
        tokens = cell.global_batch * (1 if cell.step == "decode"
                                      else cell.seq_len)
        result.update({
            "chips": n_chips,
            "build_seconds": round(counts["build_seconds"], 1),
            "trace_seconds": round(counts["trace_seconds"], 1),
            "flops_per_device": float(counts["flops"]),
            "bytes_accessed_per_device": float(counts["bytes"]),
            "collective_bytes_per_device": float(coll["total"]),
            "collectives": coll["by_op"],
            "collective_counts": coll["op_counts"],
            "collective_largest": counts["largest"],
            "kernel_calls": counts["kernel_calls"],
            "operator_calls": counts["operator_calls"],
            "memory": {"peak_bytes_per_device_est": counts["peak_bytes"]},
            "params_total": total,
            "params_active": active,
            "tokens_per_step": tokens,
            "step_kind": cell.step,
        })
        if cfg.ffn_kind == "moe" and not options.get("moe_ep"):
            result["moe_route"] = BALANCED_ROUTE
        result["roofline"] = roofline_terms(result, DEVICE)
    except Exception as e:
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
    _save(result, save)
    return result


def _save(result: dict, save: bool):
    if not save:
        return
    os.makedirs(REPORT_DIR, exist_ok=True)
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}"
    if result.get("variant") and result["variant"] != "baseline":
        name += f"__{result['variant']}"
    with open(os.path.join(REPORT_DIR, name + ".json"), "w") as f:
        json.dump(result, f, indent=1, default=str)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true",
                    help="re-run cells that already have a report")
    args = ap.parse_args()

    archs = list_configs() if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                out = os.path.join(
                    REPORT_DIR, f"{arch}__{shape}__{mesh_name}.json")
                if not args.force and os.path.exists(out):
                    with open(out) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[cached ] {arch} {shape} {mesh_name}: "
                              f"{prev['status']}")
                        continue
                t0 = time.time()
                r = run_cell(arch, shape, mp)
                dom = (r.get("roofline") or {}).get("dominant", "-")
                print(f"[{r['status']:7s}] {arch} {shape} {mesh_name} "
                      f"({time.time()-t0:.0f}s) dominant={dom}",
                      flush=True)
                if r["status"] == "error":
                    print("   ", r["error"].splitlines()[0][:200],
                          flush=True)


if __name__ == "__main__":
    main()

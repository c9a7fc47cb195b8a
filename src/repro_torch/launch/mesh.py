"""Device meshes, and the process worlds that run on them.

The JAX package's ``launch/mesh.py`` on torch.  A :class:`Mesh` mirrors
``jax.sharding.Mesh``: ``devices`` is an ndarray of ``torch.device``
laid out in the mesh's shape, with ``axis_names`` and ``shape`` (axis
name -> size).  Meshes are built by FUNCTIONS, so importing this module
touches no device state.  Single-pod: 16 x 16 = 256 cards ("data",
"model"); multi-pod: 2 x 16 x 16 = 512 ("pod", "data", "model") — the
pod axis is the slow dimension, so the sharding rules only ever place
the batch on it.

Two execution models use a mesh:

  * one controller (the relational engine): one process places each
    shard of a scan on ``mesh.devices.flat[j]`` itself;
  * SPMD (training, expert-parallel MoE, checkpoints): :func:`spawn`
    starts one process per mesh position, rank ``r`` on
    ``mesh.devices.flat[r]``, and :func:`device_mesh` gives each rank
    the ``torch.distributed`` ``DeviceMesh`` of the same shape.  On a
    gloo world of CUDA ranks DTensor's gathers and scatters run as
    all-reduces (:func:`gloo_collectives_over_all_reduce`).

The default devices are the first ``prod(shape)`` CUDA devices.  A test
mesh may name one card several times (``devices=["cuda:0"] * 4``): that
is the only way to shard on a one-card machine, and the positions then
share the card's memory and compute.
"""
from __future__ import annotations

import contextlib
import os
import re
import shutil
import tempfile
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """An n-d array of devices with one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        kinds = {d.type for d in devices.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh holds one kind of device, got "
                             f"{sorted(kinds)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    @property
    def distinct(self) -> bool:
        """True when every position is a device of its own."""
        return len({str(d) for d in self.devices.flat}) == self.size

    def __repr__(self) -> str:
        devs = ",".join(str(d) for d in self.devices.flat)
        return (f"Mesh({'x'.join(str(s) for s in self.devices.shape)}, "
                f"{self.axis_names}, [{devs}])")

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and repr(self) == repr(other))

    def __hash__(self) -> int:
        return hash(repr(self))


def _devices(n: int, devices) -> list:
    """``devices`` as n torch devices; None means the first n cards."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if len(out) != n:
            raise ValueError(f"a mesh of {n} positions needs {n} devices, "
                             f"got {len(out)}")
        return out
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        raise RuntimeError(
            f"a mesh of {n} positions needs {n} CUDA devices and {count} "
            f"are available; pass devices= (e.g. devices=['cpu'] * {n}, "
            f"or one card named several times)")
    return [torch.device("cuda", i) for i in range(n)]


def _mesh(shape, axes, devices) -> Mesh:
    n = int(np.prod(shape))
    devs = np.empty(n, dtype=object)
    devs[:] = _devices(n, devices)
    return Mesh(devs.reshape(tuple(shape)), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, devices)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   devices: Optional[Sequence] = None) -> Mesh:
    """Small mesh for tests: the first ``prod(shape)`` cards, or the
    ``devices`` given (CPU positions, or one card named repeatedly)."""
    return _mesh(shape, axes, devices)


def data_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def device_mesh(mesh: Mesh):
    """The ``DeviceMesh`` an SPMD rank of ``mesh`` computes on (the
    default process group must span the mesh, as :func:`spawn` sets
    it up)."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = np.arange(mesh.size).reshape(mesh.devices.shape)
    return DeviceMesh(mesh.device_type, ranks.tolist(),
                      mesh_dim_names=mesh.axis_names)


def backend(mesh: Mesh) -> str:
    """gloo for CPU meshes and for ranks that share a card (gloo takes
    CUDA tensors); NCCL where every position is a card of its own."""
    if mesh.device_type == "cuda" and mesh.distinct:
        return "nccl"
    return "gloo"


def _wait(t):
    from torch.distributed import _functional_collectives as funcol

    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


# the functional collectives DTensor's placements call, by their names
# in the torch releases this package runs on (2.11 has the first of
# each pair; 2.13 has both and calls the second)
_GATHERS = ("all_gather_tensor", "all_gather_single")
_SCATTERS = ("reduce_scatter_tensor", "reduce_scatter_single")
_COLLECTIVE = re.compile(r"^(all_gather|reduce_scatter|all_to_all)")


def _code_names(module) -> set:
    """Every name the functions and methods of ``module`` refer to."""
    import types

    names, todo = set(), []
    for obj in vars(module).values():
        if isinstance(obj, type) and obj.__module__ == module.__name__:
            todo += [f for f in vars(obj).values()
                     if isinstance(f, types.FunctionType)]
        elif isinstance(obj, types.FunctionType):
            todo.append(obj)
    codes = [f.__code__ for f in todo]
    while codes:
        code = codes.pop()
        names.update(code.co_names)
        codes += [c for c in code.co_consts if isinstance(c, types.CodeType)]
    return names


@contextlib.contextmanager
def gloo_collectives_over_all_reduce():
    """Inside the context, DTensor's all-gathers, reduce-scatters and
    all-to-alls in this process, and the functional all-to-alls of the
    port's MoE layer (``models/ffn.py``), run as all-reduces.

    gloo takes CUDA tensors for ``all_reduce`` and ``broadcast``, but
    DTensor's functional all-gather of CUDA tensors over gloo crashed
    the process on the H100 (torch 2.11); and gloo has had no
    reduce-scatter.  So :func:`spawn` runs a gloo world of CUDA ranks
    inside this context, where:
    an all-gather is an integer all-reduce (SUM) of the bits of each
    rank's block placed in zeros of the gathered shape — exact, as every
    position has one nonzero term; a reduce-scatter is an all-reduce
    followed by the rank's slice; a shard-to-shard all-to-all is that
    all-gather followed by the rank's chunk, as DTensor already does on
    CPU meshes; an all-to-all of rows with split sizes is an all-reduce
    of every rank's split sizes, then that all-gather of every rank's
    rows (padded to the most any rank sends) and the rank's slices of
    it.  Twice the bytes of the collective it replaces (16-bit
    entries travel as int32 words of two entries where the last dim is
    even, else each widened to an int32).

    Raises RuntimeError, rather than run DTensor's own collectives, when
    DTensor's placements call no all-gather or no reduce-scatter it
    replaces, or a functional collective it does not replace (a torch
    release that renamed one), or when a function it replaces is
    missing."""
    import torch.distributed.tensor._collective_utils as cu
    import torch.distributed.tensor.placement_types as pt
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed import distributed_c10d as c10d

    if getattr(funcol, "_repro_torch_over_all_reduce", False):
        yield
        return
    real_all_reduce = funcol.all_reduce

    def pg_of(group, tag=""):
        return c10d._resolve_process_group(
            funcol._resolve_group_name(group, tag))

    def reduce(t, op, group, tag=""):
        n = pg_of(group, tag).size()
        if op == "avg":
            return _wait(real_all_reduce(t, "sum", group, tag)) / n
        return _wait(real_all_reduce(t, op, group, tag))

    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

    def gather(self, gather_dim, group, tag=""):
        pg = pg_of(group, tag)
        n, r = pg.size(), pg.rank()
        if n == 1:
            return self
        size = self.element_size()
        src = self.contiguous()
        paired = size == 2 and src.dim() > 0 and src.shape[-1] % 2 == 0
        if paired:
            # two 16-bit patterns to an int32 word, as they lie: no word
            # holds two ranks' entries, so each word of the sum is one
            # rank's word plus zeros, at the bytes of the tensor itself
            # (viewed flat: a contiguous tensor's dim of one entry may
            # carry any stride, which a view to a wider dtype refuses)
            src = src.reshape(-1).view(torch.int32).view(
                *src.shape[:-1], src.shape[-1] // 2)
        else:
            wide = torch.int64 if size == 8 else torch.int32
            src = src.view(bits[size]).to(wide)
            if size < 4:
                # the narrow bit patterns as non-negative ints, so the
                # sum of one pattern and zeros gives the pattern back
                src &= (1 << (8 * size)) - 1
        shape = list(src.shape)
        shape[gather_dim] *= n
        out = src.new_zeros(shape)
        out.narrow(gather_dim, r * src.shape[gather_dim],
                   src.shape[gather_dim]).copy_(src)
        out = reduce(out, "sum", group, tag)
        if paired:
            return out.view(self.dtype)
        return out.to(bits[size]).view(self.dtype)

    def reduce_scatter(self, reduceOp, scatter_dim, group, tag=""):
        pg = pg_of(group, tag)
        n, r = pg.size(), pg.rank()
        full = reduce(self.contiguous(), reduceOp.lower(), group, tag)
        size = self.shape[scatter_dim] // n
        return full.narrow(scatter_dim, r * size, size).contiguous()

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        out = gather(input, gather_dim, (mesh, mesh_dim))
        parts = torch.chunk(out, mesh.size(mesh_dim), dim=shard_dim)
        r = mesh.get_local_rank(mesh_dim)
        if r >= len(parts):
            return out.narrow(shard_dim, 0, 0).contiguous()
        return parts[r].contiguous()

    def all_to_all_single(self, output_split_sizes, input_split_sizes,
                          group, tag=""):
        n, r = pg_of(group, tag).size(), pg_of(group, tag).rank()
        even = [self.shape[0] // n] * n
        send = list(input_split_sizes or even)
        table = torch.zeros((n, n), dtype=torch.int64, device=self.device)
        table[r] = torch.tensor(send, device=self.device)
        table = reduce(table, "sum", group, tag).tolist()
        if [row[r] for row in table] != list(output_split_sizes or even):
            raise RuntimeError(f"all_to_all_single: rank {r}'s split sizes "
                               f"disagree with its peers' ({table})")
        most = max(sum(row) for row in table)
        padded = self.new_zeros((most,) + tuple(self.shape[1:]))
        padded[:self.shape[0]] = self
        every = gather(padded, 0, group, tag)
        return torch.cat([every.narrow(0, s * most + sum(table[s][:r]),
                                       table[s][r]) for s in range(n)])

    # the placements must call an all-gather and a reduce-scatter this
    # context replaces, and no other functional collective (a torch
    # release that renamed one is refused rather than run unreplaced)
    called = {n for n in _code_names(pt) | _code_names(cu)
              if _COLLECTIVE.match(n) and hasattr(funcol, n)}
    problems = sorted(called - set(_GATHERS + _SCATTERS
                                   + ("all_to_all_single",)))
    problems += [f"no call of any of {names}" for names in (_GATHERS,
                                                            _SCATTERS)
                 if not called & set(names)]
    problems += [f"{m.__name__}.shard_dim_alltoall missing" for m in (cu, pt)
                 if not hasattr(m, "shard_dim_alltoall")]
    if not hasattr(funcol, "all_to_all_single"):
        problems.append("funcol.all_to_all_single missing")
    if problems:
        raise RuntimeError(
            f"gloo_collectives_over_all_reduce cannot route the DTensor "
            f"collectives of torch {torch.__version__}: {problems}")
    targets = [(funcol, n, gather) for n in _GATHERS if hasattr(funcol, n)] \
        + [(funcol, n, reduce_scatter) for n in _SCATTERS
           if hasattr(funcol, n)] \
        + [(m, "shard_dim_alltoall", alltoall) for m in (cu, pt)] \
        + [(funcol, "all_to_all_single", all_to_all_single)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in targets]
    for m, n, fn in targets:
        setattr(m, n, fn)
    funcol._repro_torch_over_all_reduce = True
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
        funcol._repro_torch_over_all_reduce = False


def _rank_main(rank: int, fn: Callable, mesh: Mesh, tmp: str,
               args) -> None:
    import pickle

    import torch.distributed as dist

    torch.set_num_threads(1)
    dev = mesh.devices.flat[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend(mesh), init_method="file://" + os.path.join(tmp, "world"),
        rank=rank, world_size=mesh.size)
    # gloo carrying CUDA tensors routes DTensor's collectives through
    # all-reduces; CPU and NCCL worlds run DTensor's own
    patch = gloo_collectives_over_all_reduce() \
        if backend(mesh) == "gloo" and mesh.device_type == "cuda" \
        else contextlib.nullcontext()
    try:
        with patch:
            out = fn(rank, mesh, *args)
        with open(os.path.join(tmp, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, mesh: Mesh, *args) -> list:
    """Run ``fn(rank, mesh, *args)`` in one process per mesh position
    and return the ranks' results (picklable host values), in rank order.
    ``fn`` must be a module-level function (the processes are spawned,
    not forked).  The
    world meets through a file in a fresh temporary directory, so
    concurrent worlds never share a port; every process is joined (an
    exception in a rank is raised here) and the directory removed."""
    import pickle

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    try:
        mp.start_processes(_rank_main, args=(fn, mesh, tmp, args),
                           nprocs=mesh.size, join=True,
                           start_method="spawn")
        out = []
        for r in range(mesh.size):
            with open(os.path.join(tmp, f"rank_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out

"""Rank functions of the port's SPMD tests (not a test module).

Each function runs on every rank of a world that
``repro_torch.launch.mesh.spawn`` starts (gloo on CPU positions), and
returns host values (numpy arrays, floats) to the test, which holds
them against the JAX package.  The module imports torch and the port
only: spawned ranks import it, and never JAX.
"""
import contextlib
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed import _functional_collectives as funcol

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch.mesh import (data_axes, device_mesh,
                                     gloo_collectives_over_all_reduce)
from repro_torch.launch.sharding import (NamedSharding, batch_shardings,
                                         device_put, opt_state_shardings,
                                         param_shardings)
from repro_torch.models.common import activation_sharding, named_leaves
from repro_torch.models.model import ShapeCell, forward, init_params, \
    model_specs
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (compress_and_reduce,
                                         init_train_state,
                                         make_compressed_train_step,
                                         make_train_step, value_and_grad)

TRAIN_ARCH = "gemma3-1b-smoke"
MOE_ARCH = "llama4-scout-17b-a16e-smoke"
B, T = 8, 32
OPT = dict(peak_lr=1e-3)
# the compressed steps: lr 1e-3 from the first step (no warmup), so each
# step moves every parameter by about 1e-3
COMP_OPT = dict(peak_lr=1e-3, warmup_steps=1)
COMP_STEPS = 2
# values a float SUM would not give back bit for bit: -0.0 + 0.0 is
# +0.0, and NaN payloads do not survive arithmetic
GATHER_PROBE = torch.tensor([-0.0, 1.5, -0.0, 0.0] * 3 + [float("nan")] * 4)


def train_batch(cfg, b=B, t=T, seed=0):
    """The JAX package's test batch: tokens and labels from one numpy
    generator, mask all ones."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, t)).astype(
                np.int32),
            "mask": np.ones((b, t), np.float32)}


def rank_batch(batch, rank: int, n: int) -> dict:
    """Rank ``rank``'s rows of a host batch, as tensors (the JAX
    package's ``P("data")`` split of dim 0 over ``n`` devices)."""
    b = len(batch["tokens"])
    return {k: torch.from_numpy(v[rank * b // n:(rank + 1) * b // n])
            for k, v in batch.items()}


def moe_config():
    return replace(get_config(MOE_ARCH), capacity_factor=8.0)


def moe_tokens(cfg):
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)


def _host(t) -> np.ndarray:
    """A numpy copy of ``t`` (gathered when a DTensor), bf16 as f32."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _tp_step(mesh) -> dict:
    """One sharded train step of gemma3-1b-smoke (params by
    ``param_shardings``, batch by ``batch_shardings``) from the port's
    seed-0 draws: loss, grad norm, every updated parameter (gathered)
    and the masters' placements."""
    cfg = get_config(TRAIN_ARCH)
    params = init_params(cfg, 0, device="cpu", masters=True)
    batch = _tensors(train_batch(cfg))
    p_sh = param_shardings(model_specs(cfg), cfg, mesh)
    params = device_put(params, p_sh)
    # m and v mirror the DTensor masters' placements; the step counter
    # is the same on every rank (opt_state_shardings: replicated)
    opt = init_train_state(cfg, params)
    assert opt_state_shardings(p_sh, mesh)["step"].spec == ()
    cell = ShapeCell("t", T, B, "train")
    batch = device_put(batch, batch_shardings(cfg, cell, mesh, batch))
    step = make_train_step(cfg, OptConfig(**OPT))
    params, opt, metrics = step(params, opt, batch)
    return {"loss": float(_host(metrics["loss"])),
            "grad_norm": float(_host(metrics["grad_norm"])),
            "params": {k: _host(v) for k, v in named_leaves(params)},
            "placements": {k: str(tuple(v.placements))
                           for k, v in named_leaves(params)}}


def tp_step_and_moe(rank, mesh):
    """The sharded train step on DTensor's own gloo collectives (the
    path an NCCL world takes) and again with them routed through
    all-reduces (the path a gloo world of CUDA ranks takes), and one
    expert-parallel forward of llama4-scout-smoke."""
    from torch.distributed.tensor.experimental import implicit_replication

    out = {"native": _tp_step(mesh)}
    with gloo_collectives_over_all_reduce():
        out["over_all_reduce"] = _tp_step(mesh)
    mcfg = moe_config()
    mparams = device_put(init_params(mcfg, 0, device="cpu"),
                         param_shardings(model_specs(mcfg), mcfg, mesh))
    toks = device_put(torch.from_numpy(moe_tokens(mcfg)),
                      NamedSharding(mesh, (data_axes(mesh),)))
    with torch.no_grad(), implicit_replication(), \
            activation_sharding(mesh, moe_ep=(data_axes(mesh), "model")):
        out["moe"] = _host(forward(mparams, toks, mcfg))
    return out


def _toy_grad(w, x):
    w = w.clone().requires_grad_(True)
    loss = torch.sum(torch.tanh(x @ w) ** 2)
    return torch.autograd.grad(loss, w)[0]


def compressed(rank, mesh, ckpt_dir):
    """Data parallelism over ("data",): the JAX package's toy
    gradient-compression check with a spy on the all-reduce dtypes;
    ``COMP_STEPS`` compressed train steps of gemma3-1b-smoke on this
    rank's slice of the batches of seeds 0, 1, ..., with this rank's f32
    gradient, the carried error feedback and the parameters after each;
    the bits of a sharded f32 tensor gathered over all-reduces; rows
    exchanged by gloo's own all-to-all and by the all-reduce route, with
    uneven split sizes; and a save of a data-sharded tree for the
    elastic restore."""
    groups = [device_mesh(mesh).get_group(a) for a in data_axes(mesh)]
    seen = []
    real = dist.all_reduce

    def spy(t, *a, **kw):
        seen.append(str(t.dtype).replace("torch.", ""))
        return real(t, *a, **kw)

    dist.all_reduce = spy
    try:
        rng = np.random.default_rng(0)
        w = torch.from_numpy((rng.standard_normal((256, 256)) * 0.05)
                             .astype(np.float32))
        x = torch.from_numpy(rng.standard_normal((32, 256))
                             .astype(np.float32))
        n = mesh.size
        xs = x[rank * 32 // n:(rank + 1) * 32 // n]
        g = _toy_grad(w, xs)
        seen.clear()
        f32 = g.clone()
        for grp in groups:
            dist.all_reduce(f32, group=grp)
            f32 = f32 / dist.get_world_size(grp)
        f32_dtypes = list(seen)
        seen.clear()
        c16, _ = compress_and_reduce(g, torch.zeros_like(g), groups)
        bf16_dtypes = list(seen)

        cfg = get_config(TRAIN_ARCH)
        params = init_params(cfg, 0, device="cpu", masters=True)
        state = init_train_state(cfg, params)
        step = make_compressed_train_step(cfg, OptConfig(**COMP_OPT), mesh,
                                          data_axes(mesh))
        steps = []
        for s in range(COMP_STEPS):
            mine = rank_batch(train_batch(cfg, seed=s), rank, n)
            # this rank's f32 gradient, as the step computes it
            _, grads = value_and_grad(params, mine, cfg)
            seen.clear()
            params, state, metrics = step(params, state, mine)
            steps.append({
                "dtypes": sorted(set(seen)),
                "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "grads": {k: _host(v) for k, v in named_leaves(grads)},
                "err": {k: _host(v) for k, v in named_leaves(state["err"])},
                "params": {k: _host(v) for k, v in named_leaves(params)}})
    finally:
        dist.all_reduce = real

    sh = NamedSharding(mesh, ("data",))
    tree = device_put({"w": torch.arange(64.0).reshape(8, 8),
                       "b": torch.arange(16, dtype=torch.bfloat16)},
                      {"w": sh, "b": sh})
    with gloo_collectives_over_all_reduce():   # the gather of the save
        CheckpointManager(ckpt_dir).save(1, tree, blocking=True)
        odd = device_put(GATHER_PROBE.clone(), sh)
        gathered = odd.full_tensor().view(torch.int32).numpy().copy()
        # the same values as bf16, two to a gathered int32 word
        odd16 = device_put(GATHER_PROBE.to(torch.bfloat16), sh)
        gathered16 = odd16.full_tensor().view(torch.int16).numpy().copy()
    # rank r sends (r + j) % 3 rows to rank j, and so receives as many
    rows = (GATHER_PROBE.reshape(8, 2) + rank).to(torch.bfloat16)
    splits = [(rank + j) % 3 for j in range(mesh.size)]
    rows = rows[:sum(splits)]
    group = (device_mesh(mesh), 0)
    own = funcol.all_to_all_single(rows, splits, splits, group).wait()
    with gloo_collectives_over_all_reduce():
        routed = funcol.all_to_all_single(rows, splits, splits, group)
    return {"f32": _host(f32), "bf16": _host(c16),
            "f32_dtypes": f32_dtypes, "bf16_dtypes": bf16_dtypes,
            "steps": steps, "gathered_bits": gathered,
            "gathered_bits_bf16": gathered16,
            "all_to_all_bits": own.view(torch.int16).numpy().copy(),
            "all_to_all_bits_routed":
                routed.view(torch.int16).numpy().copy()}


def restore(rank, mesh, ckpt_dir):
    """Restore the world-of-4 checkpoint onto this world, sharded over
    ("data",); returns each leaf's gathered value, this rank's local
    block and placements."""
    sh = NamedSharding(mesh, ("data",))
    like = {"w": torch.zeros(8, 8), "b": torch.zeros(16,
                                                     dtype=torch.bfloat16)}
    step, tree = CheckpointManager(ckpt_dir).restore(
        like, shardings={"w": sh, "b": sh})
    return {"step": step,
            "full": {k: _host(v) for k, v in tree.items()},
            "local": {k: v.to_local().clone() for k, v in tree.items()},
            "placements": {k: str(tuple(v.placements))
                           for k, v in tree.items()},
            "dtypes": {k: str(v.dtype) for k, v in tree.items()}}


DECODE_ARCHS = ("granite-8b-smoke", "gemma3-1b-smoke")
DECODE_B, DECODE_SLOTS, DECODE_POS = 4, 16, 11
# q and kv heads of split_config by mesh shape: "model" cannot split the
# kv heads, and r = 2 ranks share each with d = gcd(g, 2) = 1, so each
# kv head's keys (decode) and queries (forward) split c = 2 ways
SPLIT_HEADS = {(1, 4): (6, 2), (2, 2): (3, 1)}
SPLIT_WINDOW = 8


def split_config(mesh_shape):
    """gemma3-1b-smoke with the heads of ``SPLIT_HEADS`` and a window of
    8: its local layers' keys start inside a query chunk of 8 (T = 32,
    2c = 4 chunks) and their rolling caches of 8 slots roll by
    ``DECODE_POS``."""
    n_heads, n_kv = SPLIT_HEADS[tuple(mesh_shape)]
    return replace(get_config(TRAIN_ARCH), n_heads=n_heads,
                   n_kv_heads=n_kv, window=SPLIT_WINDOW)


def _decode_pair(cfg, mesh, batch: int) -> dict:
    """One decode step of ``cfg`` on parameters, cache and token placed
    by the sharding rules (DTensor on every rank) and on plain tensors:
    both logits and both updated caches, gathered."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.sharding import cache_shardings
    from repro_torch.models.decoder import init_cache, map_cache
    from repro_torch.models.model import decode_step

    params = init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    cache = map_cache(init_cache(cfg, batch, DECODE_SLOTS, device="cpu"),
                      lambda t: torch.randn(t.shape, generator=gen))
    token = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                          dtype=torch.int32)
    cell = ShapeCell("d", DECODE_SLOTS, batch, "decode")
    plain_cache = map_cache(cache, torch.clone)
    with torch.no_grad():
        want, _ = decode_step(params, plain_cache, token, DECODE_POS, cfg)
        p = device_put(params, param_shardings(model_specs(cfg), cfg, mesh))
        c = device_put(cache, cache_shardings(cfg, cell, mesh, cache))
        t = device_put(token, batch_shardings(
            cfg, cell, mesh, {"token": token})["token"])
        with implicit_replication():
            got, c = decode_step(p, c, t, DECODE_POS, cfg)
    return {"logits": _host(got), "want": _host(want),
            "cache": [_host(x) for _, x in named_leaves(c)],
            "want_cache": [_host(x) for _, x in named_leaves(plain_cache)],
            "k_placements": str(tuple(named_leaves(c)[0][1].placements))}


def sharded_decode(rank, mesh):
    """One decode step of each ``DECODE_ARCHS`` config
    (:func:`_decode_pair`): granite-8b-smoke's 2 kv heads split over
    "model"; gemma3-1b-smoke's one kv head cannot, so the ranks split
    its 4 q heads within it.  Under ``"split"``, :func:`split_routes`;
    under ``"unkeyed"``, the DTensor ops' arguments that the sharding
    cache leaves out of its key (:func:`unkeyed_args`), over both."""
    sizes = _collective_sizes()
    with sizes:
        out = {arch: _decode_pair(get_config(arch), mesh, DECODE_B)
               for arch in DECODE_ARCHS}
        out["split"] = split_routes(mesh)
    out["unkeyed"] = sorted(unkeyed_args(sizes.dtensor_calls))
    return out


def split_routes(mesh) -> dict:
    """The routes where two ranks share each kv head
    (:func:`split_config`), each beside the same work on plain tensors:
    a decode at batch 4 (keys split over "model") and at batch 1 (the
    cache's slots also split over "data"), a forward and the loss and
    gradients of a train step (queries in zig-zag chunks), and the
    vocab-parallel lookup."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = split_config(mesh.devices.shape)
    out = {f"decode_{b}": _decode_pair(cfg, mesh, b) for b in (DECODE_B, 1)}
    batch = _tensors(train_batch(cfg))
    cell = ShapeCell("t", T, B, "train")
    p_sh = param_shardings(model_specs(cfg), cfg, mesh)
    b_sh = batch_shardings(cfg, cell, mesh, batch)
    params = init_params(cfg, 0, device="cpu")
    with torch.no_grad():
        want = forward(params, batch["tokens"], cfg)
        p = device_put(params, p_sh)
        toks = device_put(batch, b_sh)["tokens"]
        with implicit_replication():
            got = forward(p, toks, cfg)
    out["forward"] = {"got": _host(got), "want": _host(want)}
    masters = init_params(cfg, 0, device="cpu", masters=True)
    loss, grads = value_and_grad(masters, batch, cfg)
    s_loss, s_grads = value_and_grad(device_put(masters, p_sh),
                                     device_put(batch, b_sh), cfg)
    out["train"] = {
        "loss": float(_host(s_loss)), "want_loss": float(loss),
        "grads": {k: _host(v) for k, v in named_leaves(s_grads)},
        "want_grads": {k: _host(v) for k, v in named_leaves(grads)}}
    out["lookup"] = {name: _lookup_pair(cfg, mesh, spec)
                     for name, spec in (("vocab", ("model", None)),
                                        ("vocab_fsdp", ("model", "data")))}
    return out


def _lookup_pair(cfg, mesh, spec) -> dict:
    """The embedding lookup of a (V, d) f32 table placed by ``spec``
    (the vocab over "model", and the embedding dim over "data" for the
    FSDP case) with batch-split tokens, and on plain tensors: rows, the
    gradient of a seeded linear function of them, the collectives of
    the lookup and the gradient's placements."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.model import _embed

    gen = torch.Generator().manual_seed(2)
    table = torch.randn(cfg.vocab_size, cfg.d_model, generator=gen)
    tokens = torch.from_numpy(train_batch(cfg)["tokens"])
    weight = torch.randn(B, T, cfg.d_model, generator=gen)
    plain = table.clone().requires_grad_(True)
    want = _embed({"embed": plain}, tokens)
    (want * weight).sum().backward()
    sharded = device_put(table.requires_grad_(True), NamedSharding(mesh,
                                                                   spec))
    toks = device_put(tokens, NamedSharding(mesh, (data_axes(mesh),)))
    with CommDebugMode() as comm:
        got = _embed({"embed": sharded}, toks)
    with implicit_replication():
        (got * weight).sum().backward()
    return {"rows": _host(got), "want_rows": _host(want),
            "grad": _host(sharded.grad), "want_grad": _host(plain.grad),
            "grad_placements": str(tuple(sharded.grad.placements)),
            "collectives": sorted(str(k).split(".")[-1]
                                  for k in comm.get_comm_counts())}


SCAN_ARCHS = ("falcon-mamba-7b-smoke", "recurrentgemma-9b-smoke")
SCAN_B, SCAN_T = 4, 12


def scan_blocks(rank, mesh):
    """The loss and every master's gradient of each ``SCAN_ARCHS``
    config on parameters and batch placed by the sharding rules (DTensor
    on every rank) and on plain tensors: the Mamba in-projection's
    halves, the RG-LRU gates' reduce-scatter, both scans on each rank's
    rows and channels (``models/scan_ops.py``) and the blocks' summed
    outputs, forward and backward.  Also the scans' calls and the
    placements of the scans' outputs."""
    from repro_torch.models import scan_ops

    out = {}
    for arch in SCAN_ARCHS:
        cfg = get_config(arch)
        params = init_params(cfg, 0, device="cpu", masters=True)
        batch = _tensors(train_batch(cfg, SCAN_B, SCAN_T))
        loss, grads = value_and_grad(params, batch, cfg)
        p_sh = param_shardings(model_specs(cfg), cfg, mesh)
        cell = ShapeCell("t", SCAN_T, SCAN_B, "train")
        placed = []
        real = scan_ops.on_local_shards

        def spy(fn, args, kinds):
            y = real(fn, args, kinds)
            placed.append(str(tuple(y.placements)))
            return y

        scan_ops.reset_calls()
        scan_ops.on_local_shards = spy
        try:
            d_loss, d_grads = value_and_grad(
                device_put(params, p_sh),
                device_put(batch, batch_shardings(cfg, cell, mesh, batch)),
                cfg)
        finally:
            scan_ops.on_local_shards = real
        out[arch] = {
            "loss": float(_host(d_loss)), "want_loss": float(loss),
            "grads": {k: _host(v) for k, v in named_leaves(d_grads)},
            "want_grads": {k: _host(v) for k, v in named_leaves(grads)},
            "calls": dict(scan_ops.CALLS), "placements": placed}
    return out


# the block kinds whose tensor-parallel products the autograd pair of
# ``models/common.py`` (copy_to_model / reduce_from_model) carries: dense
# GQA, GQA over one kv head, Mamba, RG-LRU with local attention, and MLA
# with the routed and shared MoE; then the routed and shared MoE again
# at another top k over the same number of experts, in the same world
PAIR_ARCHS = ("granite-8b-smoke", "gemma3-1b-smoke", "falcon-mamba-7b-smoke",
              "recurrentgemma-9b-smoke", "deepseek-v2-236b-smoke",
              "llama4-scout-17b-a16e-smoke")
PAIR_MOE_ARCHS = ("deepseek-v2-236b-smoke", "llama4-scout-17b-a16e-smoke")
PAIR_B, PAIR_T = 4, 16


# Every non-tensor argument of a DTensor op that the SPMD tests' routes
# dispatch (the train step, the MoE configs' prefill, the sharded and
# split decode routes) and that DTensor's sharding cache leaves out of
# its key (:func:`unkeyed_args`), with why it cannot decide an output's
# shape, under torch 2.13 and 2.11 (the last eight: 2.11 only).
# ``aten.topk``'s k was one (ROADMAP C7): ``route`` now takes its top k
# outside DTensor's propagation.
SHAPELESS_UNKEYED = {
    ("aten.floor_divide.default", "other"): "a scalar, elementwise",
    ("aten.full_like.default", "fill_value"): "the input's shape",
    ("aten.full_like.default", "pin_memory"): "the input's shape",
    ("aten.gelu.default", "approximate"): "elementwise",
    ("aten.gelu_backward.default", "approximate"): "elementwise",
    ("aten.index_put.default", "accumulate"): "the shape of self",
    ("aten.new_zeros.default", "device"): "size and dtype are keyed",
    ("aten.new_zeros.default", "layout"): "size and dtype are keyed",
    ("aten.new_zeros.default", "pin_memory"): "size and dtype are keyed",
    ("aten.ones_like.default", "memory_format"): "the input's shape",
    ("aten.ones_like.default", "pin_memory"): "the input's shape",
    ("aten.searchsorted.Tensor", "side"): "the values' shape",
    ("aten.softplus_backward.default", "beta"): "elementwise",
    ("aten.softplus_backward.default", "threshold"): "elementwise",
    ("aten.add.Tensor", "other"): "a scalar, elementwise",
    ("aten.clamp.default", "min"): "a scalar, elementwise",
    ("aten.pow.Tensor_Scalar", "exponent"): "a scalar, elementwise",
    ("aten.ge.Scalar", "other"): "a scalar, elementwise",
    ("aten.lt.Scalar", "other"): "a scalar, elementwise",
    ("aten.mul.Tensor", "other"): "a scalar, elementwise",
    ("aten.rsub.Scalar", "other"): "a scalar, elementwise",
    ("aten.clamp.default", "max"): "a scalar, elementwise",
}


_TENSOR = "<tensor>"     # a tensor argument, as a DTensor call keeps it


def _is_tensor_arg(a) -> bool:
    return a is _TENSOR or isinstance(a, torch.Tensor) or (
        isinstance(a, (list, tuple))
        and any(isinstance(x, torch.Tensor) for x in a))


def unkeyed_args(calls) -> set:
    """Of DTensor op calls ``(op, args, kwargs)``, each ``(op name,
    argument name)`` of a non-tensor argument that DTensor's sharding
    cache leaves out of its key: a positional one before the op's
    registered ``static_argnum`` (every one where the op registers no
    ``RuntimeSchemaInfo``), a keyword one outside its
    ``static_kwargkey``.  A cached decision is reused whatever such an
    argument is, so none may decide an output's shape."""
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    out = set()
    for func, args, kwargs in calls:
        info = prop.op_to_schema_info.get(func) or \
            prop.op_to_schema_info_for_single_dim_strategy.get(func)
        first = info.static_argnum if info else len(args)
        keys = (info.static_kwargkey or []) if info else []
        names = [a.name for a in func._schema.arguments]
        for i, a in enumerate(args[:first]):
            if not _is_tensor_arg(a):
                out.add((str(func), names[i]))
        for k, v in kwargs.items():
            if k not in keys and not _is_tensor_arg(v):
                out.add((str(func), k))
    return out


# the index_put ops that DTensor dispatches (the backward of an
# advanced-index gather is ``aten.index_put`` with accumulate=True on a
# tensor subclass); accumulate is argument 3
_INDEX_PUTS = ("aten.index_put.default", "aten.index_put_.default",
               "aten._index_put_impl_.default",
               "aten._unsafe_index_put.default")


def accumulating_scatters(calls) -> list:
    """Of DTensor op calls ``(op, args, kwargs)``, the ``index_put``
    calls that accumulate, by op name: the card's DTensor (torch 2.11)
    placed one with its values split by rows and its indices whole
    (ROADMAP C10)."""
    out = []
    for func, args, kwargs in calls:
        if str(func) not in _INDEX_PUTS:
            continue
        acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
        if acc:
            out.append(str(func))
    return sorted(out)


def _collective_sizes():
    """A dispatch mode that records each functional collective's op
    name and result bytes, as the dry run's counter does (``seen``), and
    its result's shape (``shapes``); DTensor ops are handed back to
    DTensor, whose local ops then reach the mode.  Each DTensor op call
    is kept in ``dtensor_calls`` (op, non-tensor arguments) for
    :func:`unkeyed_args`."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Sizes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []
            self.shapes = []
            self.dtensor_calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                self.dtensor_calls.append((
                    func, tuple(_TENSOR if _is_tensor_arg(a) else a
                                for a in args),
                    {k: v for k, v in (kwargs or {}).items()
                     if not _is_tensor_arg(v)}))
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            name = func._overloadpacket.__name__
            if func.namespace == "_c10d_functional" and name != "wait_tensor":
                self.seen.append((name, out.numel() * out.element_size()))
                self.shapes.append((name, tuple(out.shape)))
            return out

    return Sizes()


def tp_pair(rank, mesh):
    """Each ``PAIR_ARCHS`` config's loss and every master's gradient, the
    masters and the batch placed by the sharding rules on ``mesh``, with
    the functional collectives the step ran (op, result bytes), the
    calls of the autograd pair's backwards, the DTensor ops' arguments
    left out of the sharding cache's key (:func:`unkeyed_args`) and
    the accumulating scatters it dispatched on DTensors
    (:func:`accumulating_scatters`) and the shape of each collective's
    result (``"collective_shapes"``); the single-device step is the
    test's.  Under ``"head"``, the placements of the head's product
    (what ``_logits`` hands ``constrain``).  An MoE config also runs a
    TP prefill (:func:`_tp_prefill`) under ``"prefill"`` and its FFN in
    bf16 (:func:`_moe_bf16`) under ``"ffn_bf16"``."""
    from repro_torch.models import common
    from repro_torch.models import model as M

    calls = {"copy_to_model": 0, "reduce_from_model": 0}
    real = {name: getattr(common, cls).backward
            for name, cls in (("copy_to_model", "_CopyToModel"),
                              ("reduce_from_model", "_ReduceFromModel"))}

    def counted(name):
        def backward(ctx, g):
            calls[name] += 1
            return real[name](ctx, g)
        return staticmethod(backward)

    heads = []
    real_constrain = M.constrain

    def constrain(x, dims):
        if tuple(dims) == ("batch", None, "vocab") and \
                hasattr(x, "placements"):
            heads.append(str(tuple(x.placements)))
        return real_constrain(x, dims)

    common._CopyToModel.backward = counted("copy_to_model")
    common._ReduceFromModel.backward = counted("reduce_from_model")
    M.constrain = constrain
    out = {}
    try:
        for arch in PAIR_ARCHS:
            cfg = get_config(arch)
            params = init_params(cfg, 0, device="cpu", masters=True)
            batch = _tensors(train_batch(cfg, PAIR_B, PAIR_T))
            cell = ShapeCell("t", PAIR_T, PAIR_B, "train")
            for k in calls:
                calls[k] = 0
            heads.clear()
            sizes = _collective_sizes()
            with sizes:
                loss, grads = value_and_grad(
                    device_put(params, param_shardings(model_specs(cfg),
                                                       cfg, mesh)),
                    device_put(batch, batch_shardings(cfg, cell, mesh,
                                                      batch)), cfg)
            out[arch] = {"loss": float(_host(loss)),
                         "grads": {k: _host(v)
                                   for k, v in named_leaves(grads)},
                         "collectives": sizes.seen, "calls": dict(calls),
                         "collective_shapes": sizes.shapes,
                         "unkeyed": sorted(unkeyed_args(
                             sizes.dtensor_calls)),
                         "accumulating": accumulating_scatters(
                             sizes.dtensor_calls),
                         "head": list(heads)}
            if cfg.ffn_kind == "moe":
                out[arch]["prefill"] = _tp_prefill(cfg, mesh, batch)
                out[arch]["ffn_bf16"] = _moe_bf16(cfg, mesh)
                out[arch]["feeds"] = {
                    feed: _step_fed_by(feed, lambda: value_and_grad(
                        device_put(params, param_shardings(
                            model_specs(cfg), cfg, mesh)),
                        device_put(batch, batch_shardings(
                            cfg, cell, mesh, batch)), cfg))
                    for feed in FEEDS}
    finally:
        M.constrain = real_constrain
        common._CopyToModel.backward = staticmethod(real["copy_to_model"])
        common._ReduceFromModel.backward = staticmethod(
            real["reduce_from_model"])
    return out


# the two ways ``models/ffn.py`` feeds an expert group on DTensors
FEEDS = ("slot", "embed")


@contextlib.contextmanager
def forced_feed(feed: str):
    """Inside the context the MoE layer on DTensors takes ``feed``
    wherever it can choose (``ffn._by_slot_blocks``; slot blocks only
    where FSDP splits no expert weight); yields the list of the feeds
    that ran, one entry a layer call."""
    from repro_torch.models import ffn as F

    fed = []
    real = {f: getattr(F, f"_{f}_blocks") for f in FEEDS}
    saved = F._by_slot_blocks

    def spy(f):
        return lambda *a: fed.append(f) or real[f](*a)

    F._by_slot_blocks = lambda *a: feed == "slot"
    for f in FEEDS:
        setattr(F, f"_{f}_blocks", spy(f))
    try:
        yield fed
    finally:
        F._by_slot_blocks = saved
        for f in FEEDS:
            setattr(F, f"_{f}_blocks", real[f])


def _step_fed_by(feed: str, step) -> dict:
    """``step()`` (a loss and its gradient tree) with the MoE layer fed
    by ``feed``: the loss, every leaf's gradient and the feeds that
    ran."""
    with forced_feed(feed) as fed:
        loss, grads = step()
    return {"loss": float(_host(loss)),
            "grads": {k: _host(v) for k, v in named_leaves(grads)},
            "fed": sorted(set(fed))}


def _tp_prefill(cfg, mesh, batch) -> dict:
    """The prefill (``forward`` under no_grad, as the dry run's prefill
    cells run it) of ``cfg``'s serving parameters placed by the sharding
    rules, and on plain tensors: both logits, and the DTensor ops'
    arguments left out of the sharding cache's key."""
    from torch.distributed.tensor.experimental import implicit_replication

    params = init_params(cfg, 0, device="cpu")
    cell = ShapeCell("p", PAIR_T, PAIR_B, "prefill")
    with torch.no_grad():
        want = forward(params, batch["tokens"], cfg)
        p = device_put(params, param_shardings(model_specs(cfg), cfg, mesh))
        toks = device_put(batch, batch_shardings(cfg, cell, mesh,
                                                 batch))["tokens"]
        sizes = _collective_sizes()
        with sizes, implicit_replication():
            got = forward(p, toks, cfg)
    return {"logits": _host(got), "want": _host(want),
            "unkeyed": sorted(unkeyed_args(sizes.dtensor_calls))}


def _moe_bf16(cfg, mesh) -> dict:
    """``moe_forward`` in bf16, as training runs it (the weights require
    grad), on weights placed by ``param_shardings`` (FSDP splits the
    experts' contraction over "data" where the mesh has one) and rows
    split over the data axes, and on plain tensors: both outputs (as
    f32), and the shape of each collective's result in the DTensor
    layer's forward and backward (``"collective_shapes"``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import ffn as F
    from repro_torch.models.common import materialize_params

    p = materialize_params(F.moe_specs(cfg), 0, torch.bfloat16,
                           torch.device("cpu")).requires_grad_(True)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((PAIR_B, PAIR_T, cfg.d_model), generator=gen).to(
        torch.bfloat16)
    want = F.moe_forward(p, x, cfg, torch.bfloat16)
    pd = device_put(p, param_shardings(F.moe_specs(cfg), cfg, mesh))
    xd = device_put(x, NamedSharding(mesh, (data_axes(mesh),)))
    xd.requires_grad_(True)
    sizes = _collective_sizes()
    with implicit_replication(), sizes:
        got = F.moe_forward(pd, xd, cfg, torch.bfloat16)
        torch.autograd.grad(got.float().sum(),
                            [xd] + [v for _, v in named_leaves(pd)])
    return {"got": _host(got), "want": _host(want),
            "collective_shapes": sizes.shapes}


# deepseek-v2-smoke (top 2), llama4-scout-smoke (top 1), then
# deepseek-v2-smoke again: router logits of one shape and placement (the
# same rows, 8 experts) routed at another k in between, in one world;
# dropless at the EP test's capacity factor (moe_config), then each
# config with drops at 0.5
ROUTE_CALLS = (("deepseek-v2-236b-smoke", 8.0),
               ("llama4-scout-17b-a16e-smoke", 8.0),
               ("deepseek-v2-236b-smoke", 8.0),
               ("deepseek-v2-236b-smoke", 0.5),
               ("llama4-scout-17b-a16e-smoke", 0.5))


def moe_routes(rank, mesh, weights, rows):
    """``moe_forward`` on DTensors (not expert-parallel) for each
    ``ROUTE_CALLS`` config and capacity factor in turn: ``weights[i]``
    (numpy, the FFN's specs) placed by ``param_shardings``, ``rows[i]``
    (B, T, d) split over the data axes.  Returns each call's output and
    its route (``top_idx``, ``top_vals``, ``sorted_tok``, ``keep``,
    ``slot``), gathered, with the shapes and placements of the route's
    DTensors, and under ``"feeds"`` the call's output again with each of
    ``FEEDS`` forced (:func:`forced_feed`) and the feeds that ran."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import ffn as F

    out = []
    real = F.route
    for (arch, cf), w, x in zip(ROUTE_CALLS, weights, rows):
        cfg = replace(get_config(arch), capacity_factor=cf)
        seen = []
        F.route = lambda c, lg: seen.append(real(c, lg)) or seen[-1]
        try:
            p = device_put(_tensor_tree(w), param_shardings(
                F.moe_specs(cfg), cfg, mesh))
            xd = device_put(torch.from_numpy(x),
                            NamedSharding(mesh, (data_axes(mesh),)))
            with torch.no_grad(), implicit_replication():
                y = F.moe_forward(p, xd, cfg, torch.float32)
        finally:
            F.route = real
        r, = seen
        feeds = {}
        for feed in FEEDS:
            with forced_feed(feed) as fed, torch.no_grad(), \
                    implicit_replication():
                feeds[feed] = {"out": _host(F.moe_forward(
                    p, xd, cfg, torch.float32)), "fed": sorted(set(fed))}
        fields = ("top_idx", "top_vals", "sorted_tok", "keep", "slot")
        out.append({
            "arch": arch, "out": _host(y), "capacity": r.capacity,
            "feeds": feeds,
            **{f: _host(getattr(r, f)) for f in fields},
            "shapes": {f: (tuple(getattr(r, f).shape),
                           tuple(getattr(r, f).to_local().shape),
                           str(tuple(getattr(r, f).placements)))
                       for f in fields}})
    return out


def _tensor_tree(tree):
    """A tree of numpy arrays as tensors."""
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


# ---------------------------------------------------------------------------
# batch-1 routes on a 3-axis mesh: ("pod", "data", "model") = (2, 1, 2)
# ---------------------------------------------------------------------------
POD_MESH = (2, 1, 2)
POD_AXES = ("pod", "data", "model")
POD_DECODE_ARCHS = ("gemma3-1b-smoke", "recurrentgemma-9b-smoke",
                    "falcon-mamba-7b-smoke")
POD_PREFILL_ARCH = "granite-8b-smoke"
# 80 cache slots, decoded from position 64: the local layers' rolling
# caches hold the 64-slot window, so they roll from the first step
POD_SLOTS, POD_POS, POD_STEPS = 80, 64, 4
POD_PREFILL_T = 16
# the decode that is also held against the JAX package, from zeroed
# caches: the RG-LRU blocks and the local attention of the hybrid
POD_JAX_ARCH = "recurrentgemma-9b-smoke"
POD_JAX_SLOTS, POD_JAX_STEPS = 16, 6


def pod_tokens(cfg, steps: int, seed: int = 3) -> np.ndarray:
    """(1, steps) int32 tokens from one numpy generator."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (1, steps)).astype(np.int32)


@contextlib.contextmanager
def attention_queries():
    """Inside the context each attention kernel call's q on plain
    tensors (the single-device step's, and each rank's local heads
    inside the sharded routes) is appended to the yielded list: the
    decode wrapper as ``models.attention`` and the sharded route call
    it, and flash attention's autograd Function."""
    from repro_torch.kernels.decode_attention import ops as DO
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.models import attention as A

    seen = []
    real_decode, real_flash = DO.decode, FO._Attention

    def decode(q, *args, **kwargs):
        if not hasattr(q, "placements"):
            seen.append(q.detach().clone())
        return real_decode(q, *args, **kwargs)

    class Flash:
        @staticmethod
        def apply(q, *args):
            seen.append(q.detach().clone())
            return real_flash.apply(q, *args)

    DO.decode = A.decode = decode
    FO._Attention = Flash
    try:
        yield seen
    finally:
        DO.decode = A.decode = real_decode
        FO._Attention = real_flash


def query_heads(got: torch.Tensor, want: torch.Tensor) -> list:
    """For each q head (dim 1) of a rank's kernel call ``got``, the head
    of the single-device call ``want`` it equals (within 1e-5), -1 for
    none."""
    out = []
    for h in range(got.shape[1]):
        err = [float((got[:, h] - want[:, j]).abs().max())
               for j in range(want.shape[1])]
        out.append(int(np.argmin(err)) if min(err) <= 1e-5 else -1)
    return out


@contextlib.contextmanager
def decode_streams():
    """Inside the context the placements of the residual stream entering
    every decode block, and leaving the last, are appended to the
    yielded list ("plain" for a plain tensor)."""
    from repro_torch.models import decoder as D
    from repro_torch.models import model as M

    seen = []
    real_block, real_stack = D._block_decode, M.decoder_decode_step

    def name(x):
        return str(tuple(x.placements)) if hasattr(x, "placements") \
            else "plain"

    def block(p, x, *args, **kwargs):
        seen.append(name(x))
        return real_block(p, x, *args, **kwargs)

    def stack(*args, **kwargs):
        x, cache = real_stack(*args, **kwargs)
        seen.append(name(x))
        return x, cache

    D._block_decode, M.decoder_decode_step = block, stack
    try:
        yield seen
    finally:
        D._block_decode, M.decoder_decode_step = real_block, real_stack


def _pod_decode(cfg, mesh) -> dict:
    """``POD_STEPS`` batch-1 decode steps of ``cfg`` from a seeded cache
    of ``POD_SLOTS`` slots, on parameters, cache and tokens placed by the
    sharding rules and on plain tensors: both logits a step, both
    caches after the last, each kernel call's q heads, the stream's
    placements into each block and the collectives (op, result bytes)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.sharding import cache_shardings
    from repro_torch.models.decoder import init_cache, map_cache
    from repro_torch.models.model import decode_step

    params = init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    cache = map_cache(init_cache(cfg, 1, POD_SLOTS, device="cpu"),
                      lambda t: torch.randn(t.shape, generator=gen))
    toks = torch.from_numpy(pod_tokens(cfg, POD_STEPS))
    cell = ShapeCell("d", POD_SLOTS, 1, "decode")
    plain_cache = map_cache(cache, torch.clone)
    with torch.no_grad(), attention_queries() as want_q:
        want = [decode_step(params, plain_cache, toks[:, i:i + 1],
                            POD_POS + i, cfg)[0] for i in range(POD_STEPS)]
    with torch.no_grad():
        p = device_put(params, param_shardings(model_specs(cfg), cfg, mesh))
        c = device_put(cache, cache_shardings(cfg, cell, mesh, cache))
        sizes = _collective_sizes()
        got = []
        with attention_queries() as got_q, decode_streams() as streams, \
                sizes, implicit_replication():
            for i in range(POD_STEPS):
                tok = toks[:, i:i + 1]
                t = device_put(tok, batch_shardings(
                    cfg, cell, mesh, {"token": tok})["token"])
                lg, c = decode_step(p, c, t, POD_POS + i, cfg)
                got.append(lg)
    return {"logits": [_host(x) for x in got],
            "want": [_host(x) for x in want],
            "cache": [_host(x) for _, x in named_leaves(c)],
            "want_cache": [_host(x) for _, x in named_leaves(plain_cache)],
            "heads": [query_heads(g, w) for g, w in zip(got_q, want_q)],
            "calls": (len(got_q), len(want_q)),
            "streams": streams, "collectives": sizes.seen,
            "dtensor_calls": sizes.dtensor_calls}


def _pod_decode_from_zero(cfg, mesh) -> list:
    """The logits of ``POD_JAX_STEPS`` batch-1 decode steps of ``cfg``
    (seed-0 parameters) from zeroed caches of ``POD_JAX_SLOTS`` slots,
    placed by the sharding rules, for the test to hold against the JAX
    package's decode."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.sharding import cache_shardings
    from repro_torch.models.decoder import init_cache
    from repro_torch.models.model import decode_step

    cell = ShapeCell("d", POD_JAX_SLOTS, 1, "decode")
    cache = init_cache(cfg, 1, POD_JAX_SLOTS, device="cpu")
    toks = torch.from_numpy(pod_tokens(cfg, POD_JAX_STEPS))
    out = []
    with torch.no_grad():
        p = device_put(init_params(cfg, 0, device="cpu"),
                       param_shardings(model_specs(cfg), cfg, mesh))
        c = device_put(cache, cache_shardings(cfg, cell, mesh, cache))
        with implicit_replication():
            for i in range(POD_JAX_STEPS):
                tok = toks[:, i:i + 1]
                t = device_put(tok, batch_shardings(
                    cfg, cell, mesh, {"token": tok})["token"])
                lg, c = decode_step(p, c, t, i, cfg)
                out.append(_host(lg))
    return out


def _pod_prefill(cfg, mesh) -> dict:
    """A batch-1 tensor-parallel prefill (``forward`` under no_grad) of
    ``cfg`` on the sharding rules' placements and on plain tensors: both
    logits, each flash call's q heads and the DTensor calls."""
    from torch.distributed.tensor.experimental import implicit_replication

    params = init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(pod_tokens(cfg, POD_PREFILL_T))
    cell = ShapeCell("p", POD_PREFILL_T, 1, "prefill")
    with torch.no_grad():
        with attention_queries() as want_q:
            want = forward(params, toks, cfg)
        p = device_put(params, param_shardings(model_specs(cfg), cfg, mesh))
        t = device_put({"tokens": toks}, batch_shardings(
            cfg, cell, mesh, {"tokens": toks}))["tokens"]
        sizes = _collective_sizes()
        with attention_queries() as got_q, sizes, implicit_replication():
            got = forward(p, t, cfg)
    return {"logits": _host(got), "want": _host(want),
            "heads": [query_heads(g, w) for g, w in zip(got_q, want_q)],
            "calls": (len(got_q), len(want_q)),
            "dtensor_calls": sizes.dtensor_calls}


def pod_routes(rank, mesh):
    """The batch-1 routes on a ("pod", "data", "model") mesh: each
    ``POD_DECODE_ARCHS`` config's decode (:func:`_pod_decode`),
    ``POD_PREFILL_ARCH``'s prefill (:func:`_pod_prefill`), the decode of
    ``POD_JAX_ARCH`` from zeroed caches (:func:`_pod_decode_from_zero`)
    and, under ``"unkeyed"``, the DTensor ops' arguments that the
    sharding cache leaves out of its key (:func:`unkeyed_args`), over
    the decodes and the prefill."""
    out = {arch: _pod_decode(get_config(arch), mesh)
           for arch in POD_DECODE_ARCHS}
    out["prefill"] = _pod_prefill(get_config(POD_PREFILL_ARCH), mesh)
    out["from_zero"] = _pod_decode_from_zero(get_config(POD_JAX_ARCH), mesh)
    calls = [c for key in (*POD_DECODE_ARCHS, "prefill")
             for c in out[key].pop("dtensor_calls")]
    out["unkeyed"] = sorted(unkeyed_args(calls))
    return out


# the decode blocks on a ("data", "model") mesh whose "data" splits the
# batch: MLA and MoE, whose weights' d FSDP also splits over "data"
# (each "model" rank multiplying its share of the latent
# down-projections and the router, the output projection's partial sums
# summed to the stream's rows), and Mamba and RG-LRU (the
# in-projection's halves by an all-to-all over "model" on each rank's
# rows, the gates' reduce-scatter)
BATCH_DECODE_ARCHS = ("deepseek-v2-236b-smoke", "llama4-scout-17b-a16e-smoke",
                      "falcon-mamba-7b-smoke", "recurrentgemma-9b-smoke")


def batch_decode(rank, mesh):
    """One decode step of each ``BATCH_DECODE_ARCHS`` config at batch
    ``DECODE_B`` (:func:`_decode_pair`), with the collectives it ran (op,
    result bytes), their result shapes and the stream's placements into
    each block."""
    out = {}
    for arch in BATCH_DECODE_ARCHS:
        sizes = _collective_sizes()
        with sizes, decode_streams() as streams:
            out[arch] = _decode_pair(get_config(arch), mesh, DECODE_B)
        out[arch]["collectives"] = sizes.seen
        out[arch]["collective_shapes"] = sizes.shapes
        out[arch]["streams"] = [s for s in streams if s != "plain"]
    # one row, which "data" cannot split: the router takes the
    # replicated row's blocks of d, one "model" rank of each "data" rank
    # sums the row's expert outputs and the other none
    out["moe_one_row"] = _decode_pair(get_config(MOE_ARCH), mesh, 1)
    return out


# the TP train step's attention on the (2, 2) ("data", "model") world
# (ROADMAP C15): the rows over "data" and the heads over "model", as the
# JAX package's rules place them
ROWS_ARCHS = ("llama4-scout-17b-a16e-smoke", "granite-8b-smoke")


@contextlib.contextmanager
def attention_placements():
    """Inside the context each call of the flash route on DTensors
    (``flash_attention.ops._attention_local``) appends to the list
    yielded the placements its q, k and v arrive with (``"arrived"``)
    and those ``_head_placements`` gives q and k / v (``"placed"``)."""
    from repro_torch.kernels.flash_attention import ops as FO

    seen, local, heads = [], FO._attention_local, FO._head_placements

    def spied_local(q, k, v, *args):
        seen.append({"arrived": [str(tuple(t.placements))
                                 for t in (q, k, v)]})
        return local(q, k, v, *args)

    def spied_heads(q, n_kv):
        qp, kvp = heads(q, n_kv)
        seen[-1]["placed"] = [str(tuple(qp)), str(tuple(kvp))]
        return qp, kvp

    FO._attention_local, FO._head_placements = spied_local, spied_heads
    try:
        yield seen
    finally:
        FO._attention_local, FO._head_placements = local, heads


def attention_rows(rank, mesh):
    """Each ``ROWS_ARCHS`` config's loss and every master's gradient
    from one TP train step, the masters and the batch placed by the
    sharding rules on ``mesh``, with the placements of each attention
    call (:func:`attention_placements`)."""
    out = {}
    for arch in ROWS_ARCHS:
        cfg = get_config(arch)
        params = init_params(cfg, 0, device="cpu", masters=True)
        batch = _tensors(train_batch(cfg, PAIR_B, PAIR_T))
        cell = ShapeCell("t", PAIR_T, PAIR_B, "train")
        with attention_placements() as seen:
            loss, grads = value_and_grad(
                device_put(params, param_shardings(model_specs(cfg), cfg,
                                                   mesh)),
                device_put(batch, batch_shardings(cfg, cell, mesh, batch)),
                cfg)
        out[arch] = {"loss": float(_host(loss)),
                     "grads": {k: _host(v) for k, v in named_leaves(grads)},
                     "attention": seen}
    return out


def partial_queries(rank, mesh):
    """The flash route on the (2, 2) world with q arriving as DTensor
    hands it to llama4-scout's TP step at published widths:
    partial sums over "data", heads over "model"; k and v split by rows
    over "data" and by heads over "model".  2 rows (one a "data" rank),
    4 q / 2 kv heads, 16 tokens of 32 dims, causal.  On DTensor's own
    gloo collectives and again through
    ``gloo_collectives_over_all_reduce`` (whose all-gathers carry the
    backward's one-row blocks): the output and q / k / v's gradients of
    ``sum(out * w)`` (gathered), the placements of the call
    (:func:`attention_placements`), and a bf16 block of one row whose
    dim of one entry has stride 1, gathered over "data" by each route."""
    from torch.distributed.tensor import (DTensor, Partial, Shard,
                                          distribute_tensor)

    from repro_torch.kernels.flash_attention.ops import attention

    dm = device_mesh(mesh)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, h, 16, 32, generator=gen) for h in (4, 2, 2))
    w = torch.randn(2, 4, 16, 32, generator=gen)
    heads = q.chunk(2, dim=1)[dm.get_local_rank(1)]
    odd = torch.empty_strided((1, 4), (1, 1), dtype=torch.bfloat16)
    odd.copy_(GATHER_PROBE[:4].reshape(1, 4) + rank)
    out = {}
    for route, ctx in (("native", contextlib.nullcontext),
                       ("over_all_reduce", gloo_collectives_over_all_reduce)):
        with ctx(), attention_placements() as seen:
            # each "data" rank holds half of q: the halves sum exactly
            qd = DTensor.from_local(heads * 0.5, dm, [Partial(), Shard(1)],
                                    run_check=False).requires_grad_()
            kd, vd = (distribute_tensor(t, dm, [Shard(0), Shard(1)])
                      .requires_grad_() for t in (k, v))
            o = attention(qd, kd, vd, causal=True).full_tensor()
            grads = torch.autograd.grad((o * w).sum(), (qd, kd, vd))
            gathered = funcol.all_gather_tensor(odd, 0, (dm, 0))
        out[route] = {"out": _host(o), "grads": [_host(g) for g in grads],
                      "attention": seen,
                      "gathered": _host(torch.as_tensor(gathered))}
    # the "data" group of this rank: ranks m and m + 2 of model rank m
    out["inputs"] = {"q": q.numpy(), "k": k.numpy(), "v": v.numpy(),
                     "w": w.numpy(),
                     "odd": [_host(odd + r - rank) for r in (
                         dm.get_local_rank(1), dm.get_local_rank(1) + 2)]}
    return out

"""The time scans of the Mamba and RG-LRU blocks, as custom operators.

Each block runs its time recurrence as a plain loop over the sequence
(the JAX package's ``lax.scan`` bodies, ``repro/models/ssm.py::_ssm_scan``
and the recurrence of ``repro/models/rglru.py::rglru_forward``):
:func:`ssm_scan_loop` and :func:`rglru_scan_loop`.  Neither package has
a kernel for them.

A trace that dispatches every step of such a loop (the dry run's
``FakeTensorMode`` and ``StepCounter``, ``FlopCounterMode``) pays 32,768
steps a layer at ``prefill_32k``, and for training autograd records
each.  So each scan is also one custom operator,
``torch.ops.repro_torch.ssm_scan`` and ``torch.ops.repro_torch.rglru_scan``,
as the attention kernels are:

  * the wrappers :func:`ssm_scan` / :func:`rglru_scan` take the operator
    for a fake tensor and while a dispatch mode is active, and call the
    plain loop directly otherwise: a real tensor outside a mode runs the
    loop and records its autograd graph exactly as before;
  * the operator's implementation, on any device, is the plain loop;
  * its fake checks the inputs and returns an empty output of the
    loop's shape and dtype; an input it cannot type raises;
  * its backward is a second operator (``ssm_scan_backward`` /
    ``rglru_scan_backward``) whose implementation runs the plain loop
    again under autograd and returns ``torch.autograd.grad`` of it: the
    gradients autograd through the loop gives, bitwise;
  * on a DTensor (the dry run's shards, tensor-parallel training) the
    wrapper calls itself on each rank's local shard: every channel and
    every row of a scan is independent, so rows may be split over the
    batch axes and channels over the others with no collective; only the
    (B, T, state) inputs ``Bm`` / ``Cm`` are made whole along the channel
    split (an all-reduce of a partial sum at most).

The flop formulas count what ``FlopCounterMode`` counts for the loop,
whose only matrix product is the SSM's per-step
``einsum("bds,bs->bd", h, C_t)``, one ``bmm`` of 2 B di st flops:

  * ``ssm_scan``: 2 B T di st.  ``exp(dt A)``, the ``dt x B`` broadcast,
    the state update ``h = dA h + dBx`` and ``x D`` are elementwise and
    count 0, as in the loop;
  * ``ssm_scan_backward``: 4 B T di st, the two ``bmm`` of each step's
    einsum backward (to h and to C_t);
  * ``rglru_scan`` and its backward: 0.  Its step, ``h = a_t h + gx_t``,
    is 2 B w elementwise flops (2 B T w a scan), which no formula of the
    loop counts.

:data:`CALLS` counts the wrappers' calls by scan, whichever route they
take (these are not kernels: nothing is launched by hand).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

CALLS = {"ssm_scan": 0, "rglru_scan": 0}

# the operators' names in ``torch.ops.repro_torch``
OPERATORS = ("ssm_scan", "ssm_scan_backward", "rglru_scan",
             "rglru_scan_backward")


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


# ---------------------------------------------------------------------------
# the plain loops
# ---------------------------------------------------------------------------
def ssm_scan_loop(dt, Bm, Cm, x_in, A, D):
    """dt, x_in: (B, T, di); Bm, Cm: (B, T, st); A: (di, st); D: (di,)."""
    da = torch.exp(dt[..., None] * A)                  # (B, T, di, st)
    db_x = (dt * x_in)[..., None] * Bm[:, :, None, :]  # (B, T, di, st)
    h = torch.zeros_like(da[:, 0])
    ys = []
    for t in range(da.shape[1]):
        h = da[:, t] * h + db_x[:, t]
        ys.append(torch.einsum("bds,bs->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1) + x_in * D


def rglru_scan_loop(a_t, gx):
    """a_t, gx: (B, T, w); h_t = a_t h_{t-1} + gx_t from h = 0."""
    h = torch.zeros_like(gx[:, 0])
    hs = []
    for t in range(gx.shape[1]):
        h = a_t[:, t] * h + gx[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------
def _traced(x: torch.Tensor) -> bool:
    return isinstance(x, FakeTensor) \
        or _get_current_dispatch_mode() is not None


def ssm_scan(dt, Bm, Cm, x_in, A, D):
    """The selective scan of ``ssm_scan_loop``: the operator under a
    trace, the loop otherwise, each rank's shard for DTensors."""
    from torch.distributed.tensor import DTensor

    if isinstance(dt, DTensor):
        return on_local_shards(ssm_scan, (dt, Bm, Cm, x_in, A, D),
                               ("act", "rows", "rows", "act", "chans",
                                "chans"))
    CALLS["ssm_scan"] += 1
    if _traced(dt):
        return torch.ops.repro_torch.ssm_scan(dt, Bm, Cm, x_in, A, D)
    return ssm_scan_loop(dt, Bm, Cm, x_in, A, D)


def rglru_scan(a_t, gx):
    """The RG-LRU recurrence of ``rglru_scan_loop``: the operator under a
    trace, the loop otherwise, each rank's shard for DTensors."""
    from torch.distributed.tensor import DTensor

    if isinstance(gx, DTensor):
        return on_local_shards(rglru_scan, (a_t, gx), ("act", "act"))
    CALLS["rglru_scan"] += 1
    if _traced(gx):
        return torch.ops.repro_torch.rglru_scan(a_t, gx)
    return rglru_scan_loop(a_t, gx)


# ---------------------------------------------------------------------------
# DTensors: each rank scans its rows and channels
# ---------------------------------------------------------------------------
def _split_plan(x):
    """Per mesh dim of ``x`` (B, T, C): ``Shard(0)`` where it splits the
    rows, ``Shard(2)`` where it splits the channels, else
    ``Replicate()`` (a split of the time axis, or a partial sum, is made
    whole: a scan runs over all of T)."""
    from torch.distributed.tensor import Replicate, Shard

    return [pl if isinstance(pl, Shard) and pl.dim in (0, 2)
            else Replicate() for pl in x.placements]


def _local(x, mesh, pls, split):
    """``x`` (a DTensor, or a tensor every rank holds whole) redistributed
    to ``pls`` and its local shard.  Its gradient on a mesh dim where
    ``split`` splits the work and ``pls`` replicates ``x`` is the rank's
    share of a sum (``Partial``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    grads = [Partial() if isinstance(s, Shard) and not isinstance(p, Shard)
             else p for p, s in zip(pls, split)]
    return x.redistribute(mesh, pls).to_local(grad_placements=grads)


def on_local_shards(fn, args, kinds):
    """``fn`` over each rank's local shards of ``args`` (DTensors, or
    tensors every rank holds whole), for a function that works on each
    row and each channel of its (B, T, C) inputs on its own, over all of
    T: a time scan, a causal convolution.  ``kinds`` names each
    argument's layout: ``"act"``, (B, T, C) split as the first argument
    is along its rows and channels (:func:`_split_plan`); ``"rows"``,
    (B, T, n) split along its rows only; ``"chans"``, (C, ...) split
    along the channels.  Returns a DTensor of the first argument's shape
    placed as its local result lies."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, shape = args[0].device_mesh, args[0].shape
    act = _split_plan(args[0])
    plans = {"act": act,
             "rows": [pl if pl == Shard(0) else Replicate() for pl in act],
             "chans": [Shard(0) if pl == Shard(2) else Replicate()
                       for pl in act]}
    y = fn(*(_local(x, mesh, plans[k], act) for x, k in zip(args, kinds)))
    return DTensor.from_local(y, mesh, act, run_check=False, shape=shape,
                              stride=_dense(shape))


def _dense(shape: Sequence[int]) -> Tuple[int, ...]:
    strides, n = [], 1
    for s in reversed(shape):
        strides.append(n)
        n *= s
    return tuple(reversed(strides))


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------
@contextmanager
def _autograd_inside_operator():
    """Autograd for the ops run inside an operator's implementation, which
    the dispatcher calls below autograd (with the autograd keys excluded
    and grad mode off).  Raises where this torch cannot lift that."""
    keys = torch._C.DispatchKey
    inc = torch._C._dispatch_tls_local_include_set()
    exc = torch._C._dispatch_tls_local_exclude_set()
    exc = exc.remove(keys.AutogradFunctionality).remove(keys.ADInplaceOrView)
    with torch._C._ForceDispatchKeyGuard(inc, exc), torch.enable_grad():
        yield


def _grads_of_loop(loop, grad, inputs):
    """``torch.autograd.grad`` of ``loop(*inputs)`` against ``grad``, with
    each input a leaf: what autograd through the loop gives them."""
    with _autograd_inside_operator():
        leaves = [x.detach().requires_grad_(True) for x in inputs]
        out = loop(*leaves)
        if out.grad_fn is None:
            raise RuntimeError("the scan's recompute recorded no graph: "
                               "this torch keeps autograd off inside an "
                               "operator")
        return list(torch.autograd.grad(out, leaves, grad))


def _check(name: str, tensors, shapes) -> None:
    """Each tensor has its shape (ints; equal names must agree) and all
    share one dtype and device."""
    sizes = {}
    for t, dims in zip(tensors, shapes):
        if t.ndim != len(dims):
            raise ValueError(f"{name}: a {len(dims)}-d input "
                             f"({', '.join(dims)}) is {t.ndim}-d")
        for d, n in zip(dims, t.shape):
            if sizes.setdefault(d, n) != n:
                raise ValueError(f"{name}: {d} is {sizes[d]} and {n}")
    first = tensors[0]
    if any(t.dtype != first.dtype or t.device != first.device
           for t in tensors):
        raise ValueError(f"{name}: the inputs must share one dtype and "
                         f"device, not {[t.dtype for t in tensors]} on "
                         f"{[str(t.device) for t in tensors]}")


_SSM_SHAPES = (("B", "T", "di"), ("B", "T", "st"), ("B", "T", "st"),
               ("B", "T", "di"), ("di", "st"), ("di",))
_RGLRU_SHAPES = (("B", "T", "w"), ("B", "T", "w"))


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=())
def _ssm_op(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
            x_in: torch.Tensor, A: torch.Tensor, D: torch.Tensor
            ) -> torch.Tensor:
    return ssm_scan_loop(dt, Bm, Cm, x_in, A, D)


@_ssm_op.register_fake
def _ssm_fake(dt, Bm, Cm, x_in, A, D):
    _check("ssm_scan", (dt, Bm, Cm, x_in, A, D), _SSM_SHAPES)
    return dt.new_empty(dt.shape)


@torch.library.custom_op("repro_torch::ssm_scan_backward", mutates_args=())
def _ssm_backward_op(grad: torch.Tensor, dt: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor,
                     x_in: torch.Tensor, A: torch.Tensor, D: torch.Tensor
                     ) -> list[torch.Tensor]:
    return _grads_of_loop(ssm_scan_loop, grad, (dt, Bm, Cm, x_in, A, D))


@_ssm_backward_op.register_fake
def _ssm_backward_fake(grad, dt, Bm, Cm, x_in, A, D):
    _check("ssm_scan_backward", (grad, dt, Bm, Cm, x_in, A, D),
           (_SSM_SHAPES[0],) + _SSM_SHAPES)
    return [x.new_empty(x.shape) for x in (dt, Bm, Cm, x_in, A, D)]


def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _ssm_backward(ctx, grad):
    return tuple(torch.ops.repro_torch.ssm_scan_backward(
        grad, *ctx.saved_tensors))


_ssm_op.register_autograd(_ssm_backward, setup_context=_save_inputs)


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _rglru_op(a_t: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    return rglru_scan_loop(a_t, gx)


@_rglru_op.register_fake
def _rglru_fake(a_t, gx):
    _check("rglru_scan", (a_t, gx), _RGLRU_SHAPES)
    return gx.new_empty(gx.shape)


@torch.library.custom_op("repro_torch::rglru_scan_backward", mutates_args=())
def _rglru_backward_op(grad: torch.Tensor, a_t: torch.Tensor,
                       gx: torch.Tensor) -> list[torch.Tensor]:
    return _grads_of_loop(rglru_scan_loop, grad, (a_t, gx))


@_rglru_backward_op.register_fake
def _rglru_backward_fake(grad, a_t, gx):
    _check("rglru_scan_backward", (grad, a_t, gx),
           (_RGLRU_SHAPES[0],) + _RGLRU_SHAPES)
    return [a_t.new_empty(a_t.shape), gx.new_empty(gx.shape)]


def _rglru_backward(ctx, grad):
    return tuple(torch.ops.repro_torch.rglru_scan_backward(
        grad, *ctx.saved_tensors))


_rglru_op.register_autograd(_rglru_backward, setup_context=_save_inputs)


@register_flop_formula(torch.ops.repro_torch.ssm_scan)
def ssm_scan_flops(dt_shape, bm_shape, cm_shape, x_shape, a_shape, d_shape,
                   *, out_shape=None, **kwargs) -> int:
    b, t, di = dt_shape
    return 2 * b * t * di * bm_shape[2]


@register_flop_formula(torch.ops.repro_torch.ssm_scan_backward)
def ssm_scan_backward_flops(grad_shape, dt_shape, bm_shape, cm_shape,
                            x_shape, a_shape, d_shape, *, out_shape=None,
                            **kwargs) -> int:
    b, t, di = dt_shape
    return 4 * b * t * di * bm_shape[2]


@register_flop_formula([torch.ops.repro_torch.rglru_scan,
                        torch.ops.repro_torch.rglru_scan_backward])
def rglru_scan_flops(*shapes, out_shape=None, **kwargs) -> int:
    return 0

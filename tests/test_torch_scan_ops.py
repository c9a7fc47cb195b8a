"""The Mamba and RG-LRU time scans as custom operators
(``repro_torch.models.scan_ops``) against their plain loops and the JAX
package's ``lax.scan``s.

The same seeded numpy inputs (B 2, T 17, di 24, st 4; w 24) go through
the JAX package's ``_ssm_scan`` (``repro/models/ssm.py``) and its RG-LRU
block (``repro/models/rglru.py::rglru_forward``, whose recurrence is its
``lax.scan``), the port's plain loops, and the port's operators, which
the wrappers take under a dispatch mode.

Tolerances:
  * operator against plain loop, forward and every input's gradient:
    bitwise (the operator's implementation is the loop, and its
    backward is autograd through the loop);
  * port against the JAX package: 1e-5 absolute in f32 (the same
    products, summed in another order), 2e-2 absolute in bf16 (both
    round every step's state to bf16; values are of order 1);
  * the blocks on DTensors of a (2, 2) gloo world against the same
    blocks on plain tensors: 1e-5 (f32; the row-parallel products sum
    their parts in another order).
"""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as j_get_config
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.models import rglru as TR
from repro_torch.models import scan_ops as S
from torch_parity import one_torch_thread  # noqa: F401

B, T, DI, ST, W = 2, 17, 24, 4, 24
JAX_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DTENSOR_ATOL = 1e-5
DTYPES = (torch.float32, torch.bfloat16)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


class Passthrough(TorchDispatchMode):
    """A dispatch mode that changes nothing: under it the wrappers take
    their operators."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _ssm_inputs(seed=0):
    """dt (positive), Bm, Cm, x_in, A (negative), D as f32 numpy."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    dt = np.log1p(np.exp(n((B, T, DI)))) * 0.5
    a = -np.exp(n((DI, ST)) * 0.5)
    return [x.astype(np.float32) for x in
            (dt, n((B, T, ST)), n((B, T, ST)), n((B, T, DI)), a, n(DI))]


def _rglru_inputs(seed=1):
    """a_t in (0, 1) and gx, (B, T, w)."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, W)) - 2.0))
    return [a.astype(np.float32),
            rng.standard_normal((B, T, W)).astype(np.float32)]


def _torch(xs, dtype, grad=False):
    return [torch.from_numpy(x).to(dtype).requires_grad_(grad) for x in xs]


SCANS = {"ssm_scan": (S.ssm_scan, S.ssm_scan_loop, _ssm_inputs),
         "rglru_scan": (S.rglru_scan, S.rglru_scan_loop, _rglru_inputs)}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ssm_scan_matches_the_jax_package(dtype):
    """The loop and the operator against ``repro/models/ssm.py::
    _ssm_scan`` on the same inputs in the same dtype."""
    xs = _ssm_inputs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(JS._ssm_scan(*(jnp.asarray(x, jdt) for x in xs)),
                      np.float32)
    loop = S.ssm_scan_loop(*_torch(xs, dtype))
    with Passthrough():
        op = S.ssm_scan(*_torch(xs, dtype))
    assert torch.equal(op, loop)
    np.testing.assert_allclose(loop.float().numpy(), want, rtol=0,
                               atol=JAX_ATOL[dtype])


def _rglru_pair():
    """recurrentgemma-9b-smoke's RG-LRU block at d 16, w 24 in both
    packages, and its parameters drawn from numpy."""
    over = dict(d_model=16, lru_width=W)
    jcfg = replace(j_get_config("recurrentgemma-9b-smoke"), **over)
    tcfg = replace(get_config("recurrentgemma-9b-smoke"), **over)
    rng = np.random.default_rng(2)
    params = {k: (rng.standard_normal(spec.shape) / np.sqrt(spec.shape[0])
                  ).astype(np.float32)
              for k, spec in TR.rglru_specs(tcfg).items()}
    params["lam"] = rng.uniform(-1.0, 1.0, W).astype(np.float32)
    x = rng.standard_normal((B, T, 16)).astype(np.float32)
    return jcfg, tcfg, params, x


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rglru_block_matches_the_jax_package(dtype):
    """The RG-LRU block, whose recurrence is the loop outside a mode and
    the operator under one, against ``repro/models/rglru.py::
    rglru_forward`` (its recurrence a ``lax.scan``); the block's output
    is the recurrence's state times the gate, projected."""
    jcfg, tcfg, params, x = _rglru_pair()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    want = np.asarray(JR.rglru_forward(jp, jnp.asarray(x, jdt), jcfg, jdt),
                      np.float32)
    tp = {k: torch.from_numpy(v).to(dtype) for k, v in params.items()}
    tx = torch.from_numpy(x).to(dtype)
    loop = TR.rglru_forward(tp, tx, tcfg, dtype)
    S.reset_calls()
    with Passthrough():
        op = TR.rglru_forward(tp, tx, tcfg, dtype)
    assert S.CALLS["rglru_scan"] == 1
    assert torch.equal(op, loop)
    np.testing.assert_allclose(loop.float().numpy(), want, rtol=0,
                               atol=JAX_ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", sorted(SCANS))
def test_operator_equals_the_loop_bitwise(name, dtype):
    """Forward and every input's gradient: the operator under a dispatch
    mode against autograd through the plain loop.  Outside a mode the
    wrapper runs the loop itself (its graph is the loop's)."""
    wrapper, loop, inputs = SCANS[name]
    xs = inputs()
    plain = _torch(xs, dtype, grad=True)
    want = loop(*plain)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        tuple(want.shape)).astype(np.float32)).to(dtype)
    want_grads = torch.autograd.grad(want, plain, g)
    direct = wrapper(*_torch(xs, dtype, grad=True))
    assert "repro_torch" not in type(direct.grad_fn).__name__
    assert torch.equal(direct, want)
    leaves = _torch(xs, dtype, grad=True)
    with Passthrough():
        got = wrapper(*leaves)
        assert f"repro_torch_{name}" in type(got.grad_fn).__name__
        grads = torch.autograd.grad(got, leaves, g)
    assert torch.equal(got, want)
    assert len(grads) == len(want_grads)
    for a, b in zip(grads, want_grads):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(SCANS))
def test_fakes_and_flop_formulas(name):
    """On fake tensors the operator and its backward return empty tensors
    of the loop's shapes and dtypes, and their flop formulas count what
    ``FlopCounterMode`` counts over the loop on real tensors: the SSM's
    per-step einsum, 2 B T di st forward and 4 B T di st backward; 0 for
    the RG-LRU's elementwise step."""
    wrapper, loop, inputs = SCANS[name]
    want_fwd = 2 * B * T * DI * ST if name == "ssm_scan" else 0
    real = _torch(inputs(), torch.bfloat16, grad=True)
    with FlopCounterMode(display=False) as fc:
        y = loop(*real)
    assert fc.get_total_flops() == want_fwd
    with FlopCounterMode(display=False) as fc:
        loop(*real).backward(torch.ones_like(y))
    assert fc.get_total_flops() == 3 * want_fwd
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(x) for x in real]
        S.reset_calls()
        with FlopCounterMode(display=False) as fc:
            out = wrapper(*fake)
        assert type(out).__name__ == "FakeTensor"
        assert out.shape == y.shape and out.dtype == y.dtype
        assert S.CALLS[name] == 1
        assert fc.get_total_flops() == want_fwd
        with FlopCounterMode(display=False) as fc:
            grads = torch.autograd.grad(wrapper(*fake), fake,
                                        torch.ones_like(out))
        assert fc.get_total_flops() == 3 * want_fwd
        assert [tuple(g.shape) for g in grads] == \
            [tuple(x.shape) for x in fake]
        assert all(g.dtype == torch.bfloat16 for g in grads)
    assert S.ssm_scan_flops((B, T, DI), (B, T, ST), (B, T, ST), (B, T, DI),
                            (DI, ST), (DI,)) == 2 * B * T * DI * ST


def test_fakes_reject_inputs_they_cannot_type():
    """A shape that disagrees, a mixed dtype or a missing dim raises; the
    fake never guesses an output."""
    real = _torch(_ssm_inputs(), torch.float32)
    with FakeTensorMode() as mode:
        dt, bm, cm, x, a, d = [mode.from_tensor(t) for t in real]
        for bad, match in (((dt, bm, cm, x, a[:, :3], d), "st is 4 and 3"),
                           ((dt, bm, cm[:, :5], x, a, d), "T is 17 and 5"),
                           ((dt, bm, cm, x, a, d.to(torch.bfloat16)),
                            "one dtype"),
                           ((dt, bm, cm, x[0], a, d), "3-d")):
            with pytest.raises(ValueError, match=match):
                S.ssm_scan(*bad)
        a_t, gx = [mode.from_tensor(t)
                   for t in _torch(_rglru_inputs(), torch.float32)]
        with pytest.raises(ValueError, match="w is 24 and 23"):
            S.rglru_scan(a_t, gx[..., :23])


@pytest.mark.parametrize("name", sorted(SCANS))
def test_operators_pass_opcheck(name):
    """torch.library's own checks of the schema, the fake against the
    implementation and the autograd registration; and of the backward
    operator's schema and fake."""
    _, _, inputs = SCANS[name]
    xs = _torch(inputs(), torch.float32, grad=True)
    op = getattr(torch.ops.repro_torch, name).default
    result = torch.library.opcheck(op, xs, test_utils=(
        "test_schema", "test_faketensor", "test_autograd_registration"))
    assert set(result.values()) == {"SUCCESS"}
    bwd = getattr(torch.ops.repro_torch, name + "_backward").default
    plain = [x.detach() for x in xs]
    result = torch.library.opcheck(
        bwd, [torch.ones_like(S.ssm_scan_loop(*plain) if name == "ssm_scan"
                              else plain[1])] + plain,
        test_utils=("test_schema", "test_faketensor"))
    assert set(result.values()) == {"SUCCESS"}


def test_blocks_on_dtensors_match_the_single_device_blocks():
    """falcon-mamba-7b-smoke and recurrentgemma-9b-smoke: the loss and
    every master's gradient with parameters and batch placed by the
    sharding rules on a (2, 2) gloo world, against the same step on
    plain tensors (the Mamba in-projection's halves, the RG-LRU gates'
    reduce-scatter, the blocks' summed outputs, both scans' gradients
    as each rank's share of a sum where a mesh dim replicates an
    input).  The scans run on each rank's rows and channels, and
    their outputs stay split over both (batch over "data", channels over
    "model")."""
    import torch_spmd_workers as W
    from repro_torch.launch.mesh import make_test_mesh, spawn

    outs = spawn(W.scan_blocks, make_test_mesh(
        (2, 2), ("data", "model"), devices=["cpu"] * 4))
    for out in outs:
        for arch in W.SCAN_ARCHS:
            got = out[arch]
            np.testing.assert_allclose(got["loss"], got["want_loss"],
                                       rtol=DTENSOR_ATOL)
            assert sorted(got["grads"]) == sorted(got["want_grads"])
            for k, g in got["grads"].items():
                np.testing.assert_allclose(g, got["want_grads"][k], rtol=0,
                                           atol=DTENSOR_ATOL, err_msg=k)
            scan = "ssm_scan" if "mamba" in arch else "rglru_scan"
            kind = "mamba" if scan == "ssm_scan" else "rglru"
            cfg = get_config(arch)
            # block remat runs each pattern repeat's forward again in the
            # backward
            assert cfg.remat == "block"
            n = sum(k == kind for k in cfg.layer_kinds()) \
                + cfg.full_repeats * cfg.pattern.count(kind)
            assert got["calls"] == {**dict.fromkeys(got["calls"], 0),
                                    scan: n}, got["calls"]
            assert got["placements"] and set(got["placements"]) == {
                "(Shard(dim=0), Shard(dim=2))"}

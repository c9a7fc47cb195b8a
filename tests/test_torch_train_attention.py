"""The differentiable ``flash_attention`` wrapper and block remat.

``ops.attention`` against ``jax.vjp`` of the JAX package's custom-VJP
``attention`` (Pallas forward in interpret mode, or its XLA reference;
both recompute through ``mha_ref`` for the backward), with ``impl``
"pallas" and "xla", causal, windowed and full masks, GQA groups 1-4:
forward and q, k, v gradients within 2e-5 absolute (f32; the two sum
in other orders).  On the port alone, bitwise: the wrapper's gradients
are autograd's through ``mha_ref`` (the backward is that recompute),
both routes give the same model gradients, block remat gives the
gradients of no remat, and the cast masters reproduce serving's
parameters and its no-grad forward.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import attention as j_attention
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.models import model as TM
from repro_torch.models.common import named_leaves
from repro_torch.train.train_step import value_and_grad
from repro_torch.train.trainer import to_device
from repro_torch.data.pipeline import DataConfig, make_batch
from torch_parity import one_torch_thread  # noqa: F401

ATOL = 2e-5
CPU = "cpu"
pytestmark = pytest.mark.usefixtures("one_torch_thread")
# (B, Hq, Hkv, T, S, D, causal, window): the Pallas kernel takes whole
# 128-row blocks; T < S puts query row i at key position i + S - T
CASES = [
    (1, 4, 4, 128, 128, 32, True, None),
    (1, 4, 2, 128, 256, 32, True, None),
    (2, 8, 2, 128, 128, 64, True, 48),
    (1, 4, 1, 128, 128, 64, False, None),
]


def _inputs(seed, case):
    b, hq, hkv, t, s, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, t, d))]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_forward_and_grads_match_the_reference_vjp(case, impl):
    causal, window = case[6], case[7]
    q, k, v, g = _inputs(0, case)
    out, vjp = jax.vjp(lambda q_, k_, v_: j_attention(
        q_, k_, v_, causal, window, None, impl), q, k, v)
    want = [np.asarray(out)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = attention(tq, tk, tv, causal, window, None, impl)
    got.backward(torch.from_numpy(g))
    for name, x, y in zip(("out", "dq", "dk", "dv"),
                          (got.detach(), tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(x.numpy(), y, atol=ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_grads_are_autograd_through_the_plain_version(case, dtype):
    causal, window = case[6], case[7]
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in _inputs(1, case))
    grads = []
    for fn in (lambda *x: attention(*x, causal, window, 0.2, "pallas"),
               lambda *x: mha_ref(*x, causal=causal, window=window,
                                  sm_scale=0.2)):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fn(*xs).backward(g)
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        assert a.dtype == dtype and torch.equal(a, b)


def test_no_grad_calls_return_the_forward_and_count_no_launch():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, CASES[2]))
    FK.reset_launches()
    with torch.no_grad():
        out = attention(q, k, v, True, 48, None, "pallas")
    with torch.inference_mode():
        inf = attention(q, k, v, True, 48, None, "pallas")
    assert out.grad_fn is None
    assert torch.equal(out, mha_ref(q, k, v, causal=True, window=48))
    assert torch.equal(inf, out)
    assert FK.LAUNCHES["flash_attention"] == 0


def _batch(cfg, seq_len=48):
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=2, n_prefix_tokens=cfg.n_prefix_tokens,
                      d_model=cfg.d_model)
    return to_device(make_batch(data, 0), torch.device(CPU))


def _grads(cfg, params, batch):
    loss, grads = value_and_grad(params, batch, cfg)
    return loss, [g for _, g in named_leaves(grads)]


@pytest.mark.parametrize("arch", ["granite-8b-smoke", "gemma3-1b-smoke",
                                  "recurrentgemma-9b-smoke"])
def test_block_remat_and_both_routes_give_the_same_gradients(arch):
    """gemma3 and recurrentgemma have local (windowed) layers and a
    remainder layer outside the checkpointed repeats."""
    cfg = get_config(arch)
    params = TM.init_params(cfg, 0, CPU, masters=True)
    batch = _batch(cfg)
    runs = [_grads(replace(cfg, remat=remat, attn_impl=impl), params, batch)
            for remat, impl in (("none", "xla"), ("block", "xla"),
                                ("block", "pallas"), ("full", "pallas"))]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][1]))
        assert all(bool(g.abs().sum() > 0) for g in grads)


def test_cast_masters_are_serving_parameters_and_forward():
    """bf16: the cast of the f32 masters is the parameter tree serving
    draws from the same seed, and the no-grad forward over it is
    bitwise the serving forward, remat or not."""
    cfg = replace(get_config("granite-8b-smoke"), dtype="bfloat16")
    masters = TM.init_params(cfg, 5, CPU, masters=True)
    serving = TM.init_params(cfg, 5, CPU)
    cast = TM.cast_params(masters, cfg)
    serving_leaves = dict(named_leaves(serving))
    assert sorted(serving_leaves) == sorted(k for k, _ in named_leaves(cast))
    for key, a in named_leaves(cast):
        b = serving_leaves[key]
        assert a.dtype == b.dtype and torch.equal(a, b.detach()), key
        assert a.requires_grad and not b.requires_grad
    assert cast["final_norm"].dtype == torch.float32
    toks = _batch(cfg)["tokens"]
    with torch.no_grad():
        want = TM.forward(serving, toks, replace(cfg, remat="none"))
        got = TM.forward(cast, toks, cfg)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)

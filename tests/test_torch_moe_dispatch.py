"""The MoE FFN's dispatch and combine on plain CPU tensors, against the
formulation they replace (kept here as ``autograd_moe_forward``), where
each move between (token, choice) order, sorted-entry order and expert
slots was an advanced-index gather whose backward autograd writes as an
accumulating ``index_put``.

``models/ffn.py::moe_forward`` writes every move as a gather or a
scatter with unique indices whose backward is again one of the two.  A
permutation and a scatter with unique indices are exact, so the outputs
are bitwise equal to the old formulation's, and so is every gradient
that sums no token's k choices: the experts', the router's, the shared
expert's, and the input's at top k 1 and 2 (two terms add the same in
either order).  At top k 6 the input's gradient sums each token's six
terms in choice order where the old backward summed them in whatever
order the CPU's threads took (it is not repeatable); the two results
lie within the rounding of one sum of those terms, (n - 1) eps of the
sum of their magnitudes.  Top k 1, 2 and 6 over eight experts, with drops
(capacity factor 0.5) and without (8.0), f32 and bf16.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = pytest.importorskip("torch.nn.functional")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ffn as TF  # noqa: E402
from repro_torch.models.common import materialize_params, \
    named_leaves  # noqa: E402

ARCH = "deepseek-v2-236b-smoke"      # 8 experts, one shared expert
S, D = 48, 128


def autograd_moe_forward(p, x, cfg, dtype):
    """``moe_forward`` as it was written with advanced indexing, whose
    gathers' backwards are accumulating scatters (the reference)."""
    b, t, d = x.shape
    s = b * t
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(s, d)
    r = TF.route(cfg, xf @ p["router"])
    cap = r.capacity
    keep = r.keep[:, None].to(dtype)
    buf = xf.new_zeros((e * cap + 1, d), dtype=dtype).index_put(
        (r.slot,), xf[r.sorted_tok] * keep)
    expert_in = buf[:-1].reshape(e, cap, d)
    h = F.silu(torch.bmm(expert_in, p["w1"])) * torch.bmm(expert_in,
                                                         p["w3"])
    out_e = torch.bmm(h, p["w2"]).reshape(e * cap, d)
    gathered = out_e[torch.clamp(r.slot, max=e * cap - 1)] * keep
    contrib = gathered * r.top_vals.reshape(s * k)[r.order][:, None].to(
        dtype)
    per_entry = contrib[torch.argsort(r.order)].reshape(s, k, -1)
    out = per_entry[:, 0]
    for j in range(1, k):
        out = out + per_entry[:, j]
    if cfg.n_shared_experts:
        out = out + TF.dense_forward(p["shared"], xf, dtype)
    return out.reshape(b, t, d), r


def _inputs(cfg, dtype, seed):
    """The FFN's weights (seed 0), its (2, S / 2, D) input rows and the
    weights of the seeded linear function taken of its output."""
    p = materialize_params(TF.moe_specs(cfg), 0, dtype, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    x, w = (torch.from_numpy(rng.standard_normal((2, S // 2, D)).astype(
        np.float32)).to(dtype) for _ in range(2))
    return p, x, w


def _run(fn, cfg, dtype, seed):
    """Output, route and every gradient (input and weights) of the
    seeded linear function of ``fn``'s output."""
    p, x, w = _inputs(cfg, dtype, seed)
    leaves = dict(named_leaves(p))
    for v in leaves.values():
        v.requires_grad_(True)
    x.requires_grad_(True)
    got = fn(p, x, cfg, dtype)
    out, r = got if isinstance(got, tuple) else (got, None)
    grads = torch.autograd.grad((out.float() * w.float()).sum(),
                                [x, *leaves.values()])
    return out.detach(), r, dict(zip(["x", *leaves], grads))


def _terms(cfg, dtype, seed):
    """For each entry of the input's gradient, the number of terms it
    sums and the sum of their magnitudes (f32): each of the token's k
    dispatch entries, the router product's term and the shared expert's
    two products' terms, each taken from a leaf of its own."""
    p, x, w = _inputs(cfg, dtype, seed)
    b, t, d = x.shape
    xr, xe, x1, x3 = (x.reshape(b * t, d).clone().requires_grad_(True)
                      for _ in range(4))
    r = TF.route(cfg, xr @ p["router"])
    e, cap, k = cfg.n_experts, r.capacity, cfg.top_k
    keep = r.keep[:, None].to(dtype)
    entries = xe[r.sorted_tok]
    buf = xe.new_zeros((e * cap + 1, d)).index_put((r.slot,),
                                                   entries * keep)
    ein = buf[:-1].reshape(e, cap, d)
    h = F.silu(torch.bmm(ein, p["w1"])) * torch.bmm(ein, p["w3"])
    out_e = torch.bmm(h, p["w2"]).reshape(e * cap, d)
    contrib = out_e[torch.clamp(r.slot, max=e * cap - 1)] * keep * \
        r.top_vals.reshape(-1)[r.order][:, None].to(dtype)
    out = torch.zeros_like(xe).index_add(0, r.sorted_tok, contrib)
    sh = p["shared"]
    out = out + (F.silu(x1 @ sh["w1"]) * (x3 @ sh["w3"])) @ sh["w2"]
    g_entries, *g = torch.autograd.grad(
        (out.float() * w.reshape(b * t, d).float()).sum(),
        [entries, xr, x1, x3])
    mag = torch.zeros(b * t, d).index_add(0, r.sorted_tok,
                                          g_entries.float().abs())
    for term in g:
        mag += term.float().abs()
    return k + 3, mag


def _routed(cfg):
    seen = []
    real = TF.route

    def spy(c, logits):
        seen.append(real(c, logits))
        return seen[-1]

    def fn(p, x, c, dtype):
        TF.route = spy
        try:
            return TF.moe_forward(p, x, c, dtype), None
        finally:
            TF.route = real

    return fn, seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("capacity_factor", [0.5, 8.0],
                         ids=["drops", "dropless"])
@pytest.mark.parametrize("top_k", [1, 2, 6])
def test_dispatch_and_combine_match_the_autograd_formulation(
        top_k, capacity_factor, dtype):
    cfg = replace(get_config(ARCH), top_k=top_k,
                  capacity_factor=capacity_factor)
    assert cfg.n_experts == 8 and cfg.n_shared_experts
    fn, routes = _routed(cfg)
    out, _, grads = _run(fn, cfg, dtype, seed=top_k)
    want, r, want_grads = _run(autograd_moe_forward, cfg, dtype, seed=top_k)
    got_r, = routes
    kept = int(r.keep.sum())
    # the case is what it says: drops at 0.5, none at 8.0
    assert (kept < S * top_k) == (capacity_factor < 1), kept
    assert torch.equal(got_r.slot, r.slot) and torch.equal(got_r.keep,
                                                          r.keep)
    assert out.dtype == dtype and torch.equal(out, want)
    assert sorted(grads) == sorted(want_grads)
    for key, g in grads.items():
        w = want_grads[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key != "x" or top_k <= 2:
            assert torch.equal(g, w), (key, float((g - w).abs().max()))
            continue
        # x's gradient: each token's k dispatch terms, its router term
        # and its shared expert's two, summed in another order (the old
        # backward's accumulating scatter is not even repeatable on the
        # CPU: its threads add a token's terms in any order).  Two
        # orders of an n-term sum differ by at most (n - 1) eps of the
        # sum of the terms' magnitudes
        n, mag = _terms(cfg, dtype, seed=top_k)
        diff = (g.float() - w.float()).abs()
        bound = (n - 1) * torch.finfo(dtype).eps * mag.reshape(g.shape)
        assert bool((diff <= bound).all()), float((diff / bound).max())

"""The port's optimizer against the JAX package's: ``lr_schedule``,
``global_norm`` and ``adamw_update`` on the same numpy trees, within
1e-6 relative (f32; the scalar math runs in f32 tensors in the JAX
package's order, so the two differ only where XLA and torch round an
f32 ``cos``, ``pow``, ``sqrt`` or a sum differently), over several
steps, with clipping on and off and weight decay; and the reference
tests' cases (warmup / decay, the step against the gradient, the step
count, a clipped huge gradient)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as JO
from repro_torch.models.common import named_leaves
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         global_norm, init_opt_state,
                                         lr_schedule)

RTOL = 1e-6


def _trees(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": {"c": (13,), "d": [(3, 4), (2,)]}}

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        if isinstance(node, list):
            return [draw(v) for v in node]
        return (rng.standard_normal(node) * scale).astype(np.float32)

    return draw(shapes)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _torch(tree):
    return _map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("cfg", [
    OptConfig(peak_lr=1.0, warmup_steps=10, decay_steps=100),
    OptConfig(),
    OptConfig(peak_lr=3e-3, warmup_steps=0, decay_steps=7,
              min_lr_ratio=0.0)])
def test_lr_schedule_matches_the_reference(cfg):
    jcfg = JO.OptConfig(**cfg.__dict__)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 5000, 20000):
        got = lr_schedule(torch.tensor(step, dtype=torch.int32), cfg)
        assert got.dtype == torch.float32
        _close(got, JO.lr_schedule(jnp.int32(step), jcfg))


def test_global_norm_matches_the_reference():
    tree = _trees(0)
    _close(global_norm(_map(torch.from_numpy, tree)),
           JO.global_norm(_map(jnp.asarray, tree)))


@pytest.mark.parametrize("grad_scale,clip,wd", [
    (1e-3, 1.0, 0.1), (10.0, 1.0, 0.1), (1.0, 1e9, 0.0)])
def test_adamw_update_matches_the_reference(grad_scale, clip, wd):
    cfg = OptConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=6,
                    weight_decay=wd, grad_clip=clip)
    jcfg = JO.OptConfig(**cfg.__dict__)
    params = _trees(1)
    jp = _map(jnp.asarray, params)
    tp = _map(torch.from_numpy, params)
    js, ts = JO.init_opt_state(jp), init_opt_state(tp)
    for step in range(4):
        grads = _trees(10 + step, grad_scale)
        jp, js, jm = JO.adamw_update(jp, _map(jnp.asarray, grads), js, jcfg)
        tp, ts, tm = adamw_update(tp, _map(torch.from_numpy, grads), ts,
                                  cfg)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        for key in ("lr", "grad_norm"):
            _close(tm[key], jm[key])
        for (_, got), (_, want) in zip(named_leaves(tp),
                                       named_leaves(_torch(jp))):
            _close(got, want)
        for part in ("m", "v"):
            for (_, got), (_, want) in zip(
                    named_leaves(ts[part]),
                    named_leaves(_torch(js[part]))):
                assert got.dtype == torch.float32
                _close(got, want)


def test_lr_schedule_warmup_and_decay():
    cfg = OptConfig(peak_lr=1.0, warmup_steps=10, decay_steps=100)
    assert float(lr_schedule(torch.tensor(5), cfg)) == pytest.approx(0.5)
    assert float(lr_schedule(torch.tensor(10), cfg)) == pytest.approx(1.0)
    late = float(lr_schedule(torch.tensor(100), cfg))
    assert late == pytest.approx(cfg.peak_lr * cfg.min_lr_ratio, rel=1e-3)


def test_adamw_moves_params_against_gradient():
    params = {"w": torch.ones(4)}
    state = init_opt_state(params)
    cfg = OptConfig(peak_lr=0.1, warmup_steps=0, decay_steps=10,
                    weight_decay=0.0)
    new, state, _ = adamw_update(params, {"w": torch.ones(4)}, state, cfg)
    assert float(new["w"][0]) < 1.0
    assert int(state["step"]) == 1


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    state = init_opt_state(params)
    cfg = OptConfig(peak_lr=0.1, warmup_steps=0, grad_clip=1.0,
                    weight_decay=0.0)
    new, _, metrics = adamw_update(params, {"w": torch.full((4,), 1e6)},
                                   state, cfg)
    assert torch.isfinite(new["w"]).all()
    assert float(metrics["grad_norm"]) > 1e5


def test_masters_update_in_place_and_keep_requiring_grad():
    """The train step's masters are leaves that require grad; the update
    writes them (and m, v) in place under no_grad."""
    w = torch.ones(3, requires_grad=True)
    params = {"w": w}
    state = init_opt_state(params)
    m = state["m"]["w"]
    cfg = OptConfig(peak_lr=0.1, warmup_steps=0)
    new, state, _ = adamw_update(params, {"w": torch.ones(3)}, state, cfg)
    assert new["w"] is w and w.requires_grad and w.grad_fn is None
    assert state["m"]["w"] is m and float(m[0]) != 0.0
    assert float(w.detach()[0]) < 1.0

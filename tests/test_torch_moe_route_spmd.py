"""The port's MoE routing on DTensors (``models/ffn.py::route``), for
one top k after another in one process.

DTensor's sharding cache keys ``aten.topk`` by its arguments from index
2 on, so k is not in the key: a second ``topk`` on router logits of the
same shape and placements with another k took the first one's output
shape (torch 2.13 and 2.11).  ``route`` runs the softmax and the topk on each
rank's rows (``ffn._gate_topk``).  Two checks, each of one process or
world that routes at k = 2, then 1, then 2 (and 6):

  * a fake world of 4 ranks on a (2, 2) mesh, as ``dryrun.fake_world``
    makes one, in a subprocess: ``route`` on (64, 8) logits split by
    rows over ``data``; the global and local shapes of ``top_idx``,
    ``top_vals`` and ``slot``;
  * a (2, 2) gloo world of CPU ranks (``launch.mesh.spawn``, rank
    function ``torch_spmd_workers.moe_routes``, which imports no JAX):
    ``moe_forward`` on DTensors for deepseek-v2-smoke (top 2),
    llama4-scout-smoke (top 1) and deepseek-v2-smoke again, dropless
    at the expert-parallel test's capacity factor (8), then
    deepseek-v2-smoke and llama4-scout-smoke at 0.5, where entries drop;
    each against the JAX package's ``moe_forward`` on the same numpy
    weights and rows in this process.  Routes exactly: the top indices and the reference's own
    dispatch buffers (the sorted tokens times ``keep``, the expert
    slots), read where it hands them to ``constrain``.  Outputs within
    rtol = 1e-5 and atol = 1e-5 of their largest magnitude: the expert
    weights' lecun draws take their fan-in from the expert axis (8), as
    the JAX package's do, so outputs reach about 160, where one f32 ulp
    is 1.5e-5; the port's single-device ``moe_forward`` is 4.2e-5 off
    the JAX package's there (of a largest output of 130).
"""
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_spmd_workers as W  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh, spawn  # noqa: E402
from repro_torch.models import ffn as TF  # noqa: E402
from repro_torch.models.common import (children,  # noqa: E402
                                       materialize_params)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
TOL = 1e-5
MESH = {"data": 2, "model": 2}
ROWS, EXPERTS = 64, 8
FAKE_KS = (2, 1, 2, 6)
B, T = 4, 16                           # 64 rows, as in the fake world
pytestmark = pytest.mark.timeout(300)


def _local_shape(shape, placements: str) -> tuple:
    """The local shape of an evenly split DTensor of global ``shape``
    placed over the (2, 2) mesh as ``placements`` (its repr) says."""
    local = list(shape)
    for axis, pl in zip(MESH, placements.strip("()").split("), ")):
        if pl.startswith("Shard(dim="):
            d = int(pl[len("Shard(dim="):].split(")")[0])
            local[d] //= MESH[axis]
    return tuple(local)


_FAKE = f"""
    import dataclasses, json
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import device_mesh, make_test_mesh
    from repro_torch.models import ffn

    base = get_config("deepseek-v2-236b-smoke")
    out = []
    with fake_world(4):
        dmesh = device_mesh(make_test_mesh((2, 2), ("data", "model"),
                                           devices=["cpu"] * 4))
        gen = torch.Generator().manual_seed(0)
        for k in {FAKE_KS}:
            cfg = dataclasses.replace(base, top_k=k)
            local = torch.randn({ROWS} // 2, {EXPERTS}, generator=gen)
            logits = DTensor.from_local(local, dmesh, (Shard(0), Replicate()),
                                        run_check=False)
            with implicit_replication():
                r = ffn.route(cfg, logits)
            out.append({{f: [list(getattr(r, f).shape),
                             list(getattr(r, f).to_local().shape),
                             str(tuple(getattr(r, f).placements))]
                        for f in ("top_idx", "top_vals", "slot")}})
    print("RESULT_JSON:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_routes():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_FAKE)],
                          capture_output=True, text=True, env=env,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT_JSON:")][0]
    return json.loads(line[len("RESULT_JSON:"):])


@pytest.mark.parametrize("call", range(len(FAKE_KS)))
def test_route_shapes_for_each_top_k_in_one_fake_world(fake_routes, call):
    """The call at k = 2, 1, 2, 6 (in that order, one process): (S, k)
    gates and indices split by rows as the logits are, and S k slots."""
    k = FAKE_KS[call]
    got = fake_routes[call]
    for field, want in (("top_idx", (ROWS, k)), ("top_vals", (ROWS, k)),
                        ("slot", (ROWS * k,))):
        shape, local, placements = got[field]
        assert tuple(shape) == want, (k, field, got)
        assert tuple(local) == _local_shape(want, placements), (k, field,
                                                                got)
    assert "Shard(dim=0)" in got["top_idx"][2]
    assert tuple(got["top_idx"][1]) == (ROWS // 2, k)


@pytest.fixture(scope="module")
def world_routes():
    """The FFN weights (the port's seed-i draws of ``moe_specs``) and
    the rows of each call; the ranks' results."""
    weights, rows = [], []
    for i, (arch, _) in enumerate(W.ROUTE_CALLS):
        cfg = get_config(arch)
        p = materialize_params(TF.moe_specs(cfg), i, torch.float32, "cpu")
        weights.append(_numpy_tree(p))
        rng = np.random.default_rng(i)
        rows.append(rng.standard_normal((B, T, cfg.d_model))
                    .astype(np.float32))
    mesh = make_test_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    return weights, rows, spawn(W.moe_routes, mesh, weights, rows)


def _numpy_tree(tree):
    """A ParamTree as nested dicts of numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy().copy()
    return {k: _numpy_tree(v) for k, v in children(tree)}


@pytest.mark.parametrize("call", range(len(W.ROUTE_CALLS)))
def test_moe_forward_on_dtensors_matches_the_reference(world_routes, call,
                                                       monkeypatch):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.models import common as j_common
    from repro.models import ffn as JF

    weights, rows, ranks = world_routes
    arch, cf = W.ROUTE_CALLS[call]
    jcfg = replace(j_get_config(arch), capacity_factor=cf)
    tcfg = replace(get_config(arch), capacity_factor=cf)
    assert jcfg.top_k == tcfg.top_k
    seen = []
    monkeypatch.setattr(j_common, "constrain",
                        lambda x, dims: seen.append(np.array(x)) or x)
    jp = jax.tree.map(jnp.asarray, weights[call])
    x = rows[call]
    want = np.asarray(JF.moe_forward(jp, jnp.asarray(x), jcfg, jnp.float32))
    j_src, j_expert_in = seen[1], seen[2]
    xf = x.reshape(B * T, -1)
    gates = jax.nn.softmax((jnp.asarray(xf) @ jp["router"])
                           .astype(jnp.float32), axis=-1)
    _, j_top = jax.lax.top_k(gates, jcfg.top_k)

    k = tcfg.top_k
    for rank, per_call in enumerate(ranks):
        got = per_call[call]
        assert got["arch"] == arch
        for field, shape in (("top_idx", (B * T, k)), ("top_vals", (B * T, k)),
                             ("slot", (B * T * k,))):
            g_shape, l_shape, placements = got["shapes"][field]
            assert g_shape == shape and got[field].shape == shape, \
                (rank, field, got["shapes"])
            assert l_shape == _local_shape(shape, placements), \
                (rank, field, got["shapes"])
        np.testing.assert_array_equal(got["top_idx"], np.asarray(j_top))
        # the kept entries and their slots: the reference's own buffers
        keep = got["keep"].astype(np.float32)[:, None]
        src = xf[got["sorted_tok"]] * keep
        np.testing.assert_array_equal(src, j_src)
        kept = int(got["keep"].sum())
        assert (kept == B * T * k) if cf >= tcfg.n_experts / k \
            else 0 < kept < B * T * k
        buf = np.zeros((tcfg.n_experts * got["capacity"] + 1, tcfg.d_model),
                       np.float32)
        buf[got["slot"]] = src
        np.testing.assert_array_equal(
            buf[:-1].reshape(tcfg.n_experts, got["capacity"], -1),
            j_expert_in)
        np.testing.assert_allclose(got["out"], want, rtol=TOL,
                                   atol=TOL * float(np.abs(want).max()),
                                   err_msg=f"{arch} rank {rank}")


@pytest.mark.parametrize("feed", W.FEEDS)
@pytest.mark.parametrize("call", range(len(W.ROUTE_CALLS)))
def test_each_feed_matches_the_reference(world_routes, call, feed):
    """Each call again with its expert groups fed each way
    (``torch_spmd_workers.forced_feed``): slot blocks exchange the
    entries by an all-to-all over "data" and multiply the group's
    weights gathered over FSDP's "data"; embed blocks reduce-scatter
    the group's capacity by d.  Both within the limits above of the JAX
    package's ``moe_forward``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.models import ffn as JF

    weights, rows, ranks = world_routes
    arch, cf = W.ROUTE_CALLS[call]
    jcfg = replace(j_get_config(arch), capacity_factor=cf)
    want = np.asarray(JF.moe_forward(jax.tree.map(jnp.asarray,
                                                  weights[call]),
                                     jnp.asarray(rows[call]), jcfg,
                                     jnp.float32))
    for rank, per_call in enumerate(ranks):
        got = per_call[call]["feeds"][feed]
        assert got["fed"] == [feed], (arch, rank, got["fed"])
        np.testing.assert_allclose(got["out"], want, rtol=TOL,
                                   atol=TOL * float(np.abs(want).max()),
                                   err_msg=f"{arch} rank {rank} {feed}")

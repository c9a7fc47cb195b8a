"""The port's sharding rules and meshes against the JAX package's.

For every registered config, on the meshes the JAX package's tests and
dry run use, the port's ``param_shardings`` / ``opt_state_shardings`` /
``batch_shardings`` / ``cache_shardings`` specs equal the JAX package's
leaf for leaf.  The JAX package's rule functions run on a stand-in mesh
(only its axis names and shape are read) with ``NamedSharding`` swapped
for its spec, so no device of that size is needed.  The port stores a
model's pattern repeats as a list, so a JAX ``layers/scan`` leaf's spec
is compared, without its leading (replicated) layers entry, with every
repeat's.  No process group is started here.
"""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.models import decoder as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import sharding as TS  # noqa: E402
from repro_torch.launch.mesh import (Mesh, data_axes,  # noqa: E402
                                     make_production_mesh, make_test_mesh)
from repro_torch.models import decoder as TD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = [((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
          ((8,), ("data",)), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CONFIGS = list_configs()


def _norm(spec):
    """A spec as a tuple of None / tuples of axis names."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


@pytest.fixture
def ref_specs(monkeypatch):
    """The JAX package's rules with NamedSharding(mesh, spec) -> spec."""
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: _norm(spec))
    return JS


def _meshes(shape, axes):
    jmesh = SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    tmesh = make_test_mesh(shape, axes,
                           devices=["cpu"] * int(np.prod(shape)))
    return jmesh, tmesh


def _flat_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, tuple))[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)] = leaf
    return out


def _flat_port(tree, prefix=""):
    if isinstance(tree, TS.NamedSharding):
        return {prefix: _norm(tree.spec)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_port(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _match(jflat, tflat, scanned_leading: bool):
    """Every port leaf's spec equals its JAX leaf's (scan repeats
    against the stacked leaf without its leading entry)."""
    assert tflat
    for key, spec in tflat.items():
        parts = key.split("/")
        if "scan" in parts:
            i = parts.index("scan")
            jkey = "/".join(parts[:i + 1] + parts[i + 2:])
            want = jflat[jkey]
            if scanned_leading:
                assert want[0] is None, (key, want)
                want = want[1:]
        else:
            want = jflat[key]
        assert spec == want, (key, spec, want)
    n_jax = len(jflat)
    assert n_jax <= len(tflat), (n_jax, len(tflat))


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, m[0])) for m in MESHES])
@pytest.mark.parametrize("name", CONFIGS)
def test_param_and_opt_specs_equal_the_reference(name, shape, axes,
                                                 ref_specs):
    jcfg, tcfg = j_get_config(name), get_config(name)
    jmesh, tmesh = _meshes(shape, axes)
    jp = ref_specs.param_shardings(JM.model_specs(jcfg), jcfg, jmesh)
    tp = TS.param_shardings(TM.model_specs(tcfg), tcfg, tmesh)
    _match(_flat_jax(jp), _flat_port(tp), scanned_leading=True)
    jo = ref_specs.opt_state_shardings(jp, jmesh)
    to = TS.opt_state_shardings(tp, tmesh)
    assert _norm(to["step"].spec) == jo["step"] == ()
    _match(_flat_jax(jo["m"]), _flat_port(to["m"]), scanned_leading=True)


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, m[0])) for m in MESHES])
@pytest.mark.parametrize("name", CONFIGS)
def test_batch_and_cache_specs_equal_the_reference(name, shape, axes,
                                                   ref_specs):
    jcfg, tcfg = j_get_config(name), get_config(name)
    jmesh, tmesh = _meshes(shape, axes)
    for cell in JM.SHAPES:
        tcell = TM.get_shape(cell.name)
        assert (tcell.seq_len, tcell.global_batch, tcell.step) == \
            (cell.seq_len, cell.global_batch, cell.step)
        abstract = JM.input_specs(jcfg, cell)
        jb = ref_specs.batch_shardings(jcfg, cell, jmesh, abstract)
        tb = TS.batch_shardings(tcfg, tcell, tmesh, {
            k: SimpleNamespace(shape=v.shape) for k, v in abstract.items()})
        assert _flat_port(tb) == _flat_jax(jb), cell.name
        if cell.step != "decode":
            continue
        b, t = cell.global_batch, cell.seq_len
        jcache = jax.eval_shape(lambda: JD.init_cache(jcfg, b, t))
        tcache = TD.init_cache(tcfg, b, t, device="meta")
        for kv_seq_model in (False, True):
            jc = ref_specs.cache_shardings(jcfg, cell, jmesh, jcache,
                                           kv_seq_model)
            tc = TS.cache_shardings(tcfg, tcell, tmesh, tcache,
                                    kv_seq_model)
            _match(_flat_jax(jc), _flat_port(tc), scanned_leading=True)


def test_placements_by_hand():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"),
                          devices=["cpu"] * 8)
    NS = TS.NamedSharding
    assert TS.placements(NS(mesh, ())) == (Replicate(),) * 3
    assert TS.placements(NS(mesh, (("pod", "data"), None))) == \
        (Shard(0), Shard(0), Replicate())
    assert TS.placements(NS(mesh, (None, "model"))) == \
        (Replicate(), Replicate(), Shard(1))
    assert TS.placements(NS(mesh, ("data", None, "model"))) == \
        (Replicate(), Shard(0), Shard(2))
    with pytest.raises(ValueError, match="mesh order"):
        TS.placements(NS(mesh, (("model", "data"),)))


def test_mesh_helpers():
    mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
    assert isinstance(mesh, Mesh)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert mesh.devices.shape == (2, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert not mesh.distinct and mesh.device_type == "cpu"
    assert data_axes(mesh) == ("data",)
    assert data_axes(make_test_mesh((2, 2, 2), ("pod", "data", "model"),
                                    devices=["cpu"] * 8)) == ("pod", "data")
    with pytest.raises(ValueError):
        make_test_mesh((2, 2), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="one kind"):
        make_test_mesh((2,), ("data",), devices=["cpu", "meta"])
    if not torch.cuda.is_available():
        for build in (lambda: make_test_mesh((2, 2)),
                      lambda: make_production_mesh(),
                      lambda: make_production_mesh(multi_pod=True)):
            with pytest.raises(RuntimeError, match="devices="):
                build()


def test_gloo_patch_is_undone_and_refuses_collectives_it_does_not_route(
        monkeypatch):
    """``gloo_collectives_over_all_reduce`` replaces DTensor's gathers
    inside its context only, and refuses a torch whose placements call
    a functional collective it does not replace."""
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.launch import mesh as M

    real = funcol.all_gather_tensor
    with M.gloo_collectives_over_all_reduce():
        assert funcol.all_gather_tensor is not real
    assert funcol.all_gather_tensor is real
    monkeypatch.setattr(funcol, "all_gather_renamed", real, raising=False)
    monkeypatch.setattr(M, "_code_names", lambda module: {
        "all_gather_renamed", "all_gather_tensor", "reduce_scatter_tensor"})
    with pytest.raises(RuntimeError, match="all_gather_renamed"):
        with M.gloo_collectives_over_all_reduce():
            pass
    monkeypatch.setattr(M, "_code_names", lambda module: {
        "all_gather_tensor"})
    with pytest.raises(RuntimeError, match="reduce_scatter"):
        with M.gloo_collectives_over_all_reduce():
            pass
    assert funcol.all_gather_tensor is real


def test_importing_the_mesh_modules_touches_no_device():
    code = ("import sys, torch, repro_torch.launch.mesh, "
            "repro_torch.launch.sharding; "
            "import torch.distributed as dist; "
            "print(torch.cuda.is_initialized(), dist.is_initialized(), "
            "'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.split() == ["False", "False", "False"]


@pytest.mark.parametrize("n_hosts", [2, 4])
def test_host_batches_are_the_batch_shardings_dim0_blocks(n_hosts):
    """Each rank's host batch (``DataConfig.process_index`` /
    ``process_count``) equals the JAX package's batch for that host, and
    stacking the hosts' batches in rank order puts each in the dim-0
    block that ``batch_shardings`` gives its rank."""
    from torch.distributed.tensor import Shard

    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import make_batch as j_make_batch
    from repro_torch.data.pipeline import DataConfig, make_batch

    kw = dict(vocab_size=512, seq_len=16, global_batch=8)
    hosts = [make_batch(DataConfig(process_index=r, process_count=n_hosts,
                                   **kw), 3) for r in range(n_hosts)]
    for r, hb in enumerate(hosts):
        want = j_make_batch(JDataConfig(process_index=r,
                                        process_count=n_hosts, **kw), 3)
        assert sorted(hb) == sorted(want)
        for k in hb:
            np.testing.assert_array_equal(hb[k], np.asarray(want[k]))
    mesh = make_test_mesh((n_hosts,), ("data",),
                          devices=["cpu"] * n_hosts)
    cell = TM.ShapeCell("t", 16, 8, "train")
    glob = {k: np.concatenate([h[k] for h in hosts]) for k in hosts[0]}
    sh = TS.batch_shardings(get_config("granite-8b"), cell, mesh, glob)
    for k, arr in glob.items():
        assert TS.placements(sh[k]) == (Shard(0),)
        for r, block in enumerate(np.split(arr, n_hosts)):
            np.testing.assert_array_equal(block, hosts[r][k])

"""The port's SPMD paths in spawned gloo worlds of CPU ranks, against
the JAX package (the checks of ``tests/test_spmd.py``).

Three worlds, each started by ``repro_torch.launch.mesh.spawn`` with
the rank functions of ``torch_spmd_workers.py``:

  * (2, 2) ("data", "model"): one train step of gemma3-1b-smoke on
    DTensor masters placed by ``param_shardings`` and a batch placed by
    ``batch_shardings``, against the JAX package's single-device step
    from the same (carried) parameters — loss within 1e-4, parameters
    within ``atol=2e-5``, as the JAX package asserts of its own sharded
    step — once on DTensor's own gloo collectives and once with them
    routed through all-reduces; and the expert-parallel MoE forward of
    llama4-scout-smoke (``capacity_factor=8``) against the JAX
    ``forward`` within 3e-4;
  * (4,) ("data",): bf16 gradient compression — the all-reduce runs in
    bf16 for the compressed step and in f32 for the plain one, numerics
    within ``atol=1e-2, rtol=2e-2``; two compressed train steps against
    the JAX package's ``make_compressed_train_step`` on 4 host devices
    (a subprocess, as ``tests/test_spmd.py`` runs it) and against the
    port's single-device f32 step; a data-sharded tree saved;
  * (2,) ("data",): that checkpoint restored onto 2 ranks, bitwise,
    each rank holding its own rows.

The compressed steps are compared by their updates.  With lr 1e-3 from
the first step, AdamW moves each parameter by about lr * m / |m|, so a
step that updates nothing, or follows the negated gradient, is off by
about lr or 2 lr.  The allowance of each entry follows from how far
its first moment m may move under the bf16 rounding (``BF16_SLACK`` of
the largest |g + err| over the ranks, the carried err, and the f32
gradient tolerance of ``torch_train_parity``): 2 lr where that could
flip the sign of m, ``UPDATE_RTOL`` lr where it is far from doing so
(:func:`_check_updates`).  The carried error feedback is checked
exactly against each rank's own gradient: err = (g + err') -
bf16(g + err').
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_spmd_workers as W  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.train_step import init_train_state as j_init  # noqa: E402
from repro.train.train_step import make_train_step as j_step  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh, spawn  # noqa: E402
from repro_torch.models.common import named_leaves  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import (init_train_state,  # noqa: E402
                                         make_train_step, value_and_grad)
from torch_train_parity import (_grad_tol, flat_reference,  # noqa: E402
                                reference_tree)

CPU = torch.device("cpu")
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
# bf16 keeps 8 significant bits: a rounding moves a value by at most
# 2^-8 of it.  With x the largest |g + err| over 4 ranks, the rounded
# inputs move their mean by 2^-8 x, and the three bf16 additions of the
# sum (partial sums up to 2x, 3x, 4x, then / 4) by 9/4 2^-8 x more:
# 13/4 2^-8 x < 2^-6 x in all
BF16_SLACK = 2.0 ** -6
# a step's update agrees to this fraction of lr where the sign of the
# reduced gradient is fixed (the second AdamW step sees the bf16
# rounding of g, about 2^-8 of it)
UPDATE_RTOL = 2.0 ** -5
# a wedged rank fails its test instead of holding the run (pytest-timeout)
pytestmark = pytest.mark.timeout(300)


def _cpu_mesh(shape, axes):
    return make_test_mesh(shape, axes,
                          devices=["cpu"] * int(np.prod(shape)))


@pytest.fixture(scope="module")
def tp_world():
    return spawn(W.tp_step_and_moe, _cpu_mesh((2, 2), ("data", "model")))


@pytest.fixture(scope="module")
def dp_world(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("elastic"))
    return ckpt, spawn(W.compressed, _cpu_mesh((4,), ("data",)), ckpt)


@pytest.fixture(scope="module")
def jax_compressed(tmp_path_factory):
    """``COMP_STEPS`` steps of the JAX package's compressed train step
    under ``shard_map`` over 4 forced host devices, from the port's
    seed-0 draws and the batches the port's ranks take: per step the
    parameters, AdamW's ``m`` (0.1 x the clipped reduced gradient at
    step 1), each rank's ``err``, rank 0's loss, ``lr`` and the grad
    norm."""
    out = str(tmp_path_factory.mktemp("jax_compressed") / "steps.pkl")
    code = f"""
        import pickle
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        try:
            from jax import shard_map as _sm
        except ImportError:
            from jax.experimental.shard_map import shard_map as _sm
        from repro.configs import get_config
        from repro.launch.mesh import make_test_mesh
        from repro.train.optimizer import OptConfig
        from repro.train.train_step import (init_train_state,
                                            make_compressed_train_step)
        import torch_spmd_workers as W
        from torch_train_parity import flat_reference, reference_tree
        from repro_torch.models.model import init_params

        def shard_map(f, **kw):
            try:
                return _sm(f, **kw, check_vma=False)
            except TypeError:
                return _sm(f, **kw, check_rep=False)

        n = 4
        cfg = get_config(W.TRAIN_ARCH)
        params = jax.tree.map(jnp.asarray, reference_tree(
            init_params(W.get_config(W.TRAIN_ARCH), 0, "cpu",
                        masters=True)))
        state = dict(init_train_state(cfg, params))
        state["err"] = jax.tree.map(
            lambda p: jnp.zeros((n,) + p.shape, jnp.float32), params)
        step = make_compressed_train_step(cfg, OptConfig(**W.COMP_OPT),
                                          None, ("data",))

        def body(p, o, b):
            # each device's err is its own: a leading axis split on "data"
            o = dict(o, err=jax.tree.map(lambda e: e[0], o["err"]))
            p, o, m = step(p, o, b)
            return p, dict(o, err=jax.tree.map(lambda e: e[None],
                                               o["err"])), m

        o_spec = dict(m=P(), v=P(), step=P(), err=P("data"))
        fn = jax.jit(shard_map(
            body, mesh=make_test_mesh((n,), ("data",)),
            in_specs=(P(), o_spec, P("data")), out_specs=(P(), o_spec, P())))
        steps = []
        for s in range(W.COMP_STEPS):
            batch = {{k: jnp.asarray(v) for k, v in
                     W.train_batch(cfg, seed=s).items()}}
            params, state, metrics = fn(params, state, batch)
            steps.append(dict(
                params=flat_reference(params), m=flat_reference(state["m"]),
                err=[flat_reference(jax.tree.map(lambda e: e[r],
                                                 state["err"]))
                     for r in range(n)],
                **{{k: float(metrics[k]) for k in ("loss", "lr",
                                                   "grad_norm")}}))
        with open({out!r}, "wb") as f:
            pickle.dump(steps, f)
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        + env.get("XLA_FLAGS", ""))
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, TESTS, env.get("PYTHONPATH", "")])
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _slack(ranks) -> dict:
    """Per leaf, how far the reduced gradient of one step may lie from
    another evaluation's: its bf16 rounding, the error feedback added
    to it, and the f32 gradient tolerance.  ``ranks`` holds each rank's
    inputs to the step (:func:`_rank_inputs`)."""
    out = {}
    for key in ranks[0]["grads"]:
        x = np.max([np.abs(r["grads"][key] + r["err_in"][key])
                    for r in ranks], axis=0)
        e = np.max([np.abs(r["err_in"][key]) for r in ranks], axis=0)
        out[key] = BF16_SLACK * x + e + _grad_tol(x)
    return out


def _rank_inputs(outs, s: int):
    """Each rank's f32 gradient at step ``s`` and the err it carried
    into that step (zeros at the first)."""
    steps = []
    for out in outs:
        prev = out["steps"][s - 1]["err"] if s else {
            k: np.zeros_like(v) for k, v in out["steps"][0]["err"].items()}
        steps.append({"grads": out["steps"][s]["grads"], "err_in": prev})
    return steps


def _check_updates(got, want, moments, outs, label: str) -> None:
    """Parameters after each step against another evaluation's.

    ``moments`` holds, per step, that evaluation's AdamW first moment
    ``m``, its ``lr`` and its clipping ``scale``.  A step moves an entry
    by lr * m_hat / sqrt(v_hat), at most about lr; a change of m by
    ``dm`` moves it by at most about lr * dm / |m|.  ``dm`` is bounded
    by the reduced gradients' slack, carried into m as AdamW carries
    the gradients: so each step may differ by 2 lr * min(1, dm / |m|),
    and by ``UPDATE_RTOL`` of lr.  Where that allowance is below lr / 2
    (half of the entries at least), a step that updates nothing, or
    follows the negated gradient, fails."""
    b1 = JOptConfig(**W.COMP_OPT).b1
    dm, allow, n_all, n_tight = None, None, 0, 0
    for s, mo in enumerate(moments):
        slack = _slack(_rank_inputs(outs, s))
        dm = {k: (b1 * dm[k] if dm else 0) + (1 - b1) * mo["scale"] * u
              for k, u in slack.items()}
        step = {k: 2 * mo["lr"] * np.minimum(1.0, dm[k] / np.maximum(
                    np.abs(m), 1e-30)) + UPDATE_RTOL * mo["lr"]
                for k, m in mo["m"].items()}
        allow = {k: (allow[k] if allow else 0) + a for k, a in step.items()}
        for key, w in want[s].items():
            diff = np.abs(got[s][key] - w)
            assert (diff <= allow[key]).all(), (
                label, s, key, float((diff - allow[key]).max()))
            n_all += diff.size
            n_tight += int((step[key] < mo["lr"] / 2).sum())
    assert n_tight >= 0.5 * n_all, (label, n_tight, n_all)


class TestShardedTrainStep:
    def test_train_step_matches_single_device(self, tp_world):
        cfg = j_get_config(W.TRAIN_ARCH)
        tp = init_params(W.get_config(W.TRAIN_ARCH), 0, CPU, masters=True)
        jp = jax.tree.map(jnp.asarray, reference_tree(tp))
        batch = {k: jnp.asarray(v) for k, v in W.train_batch(cfg).items()}
        p1, _, m1 = jax.jit(j_step(cfg, JOptConfig(**W.OPT)))(
            jp, j_init(cfg, jp), batch)
        want = flat_reference(p1)
        routes = [o[r] for o in tp_world
                  for r in ("native", "over_all_reduce")]
        for out in routes:                    # every rank's gathered view
            assert abs(out["loss"] - float(m1["loss"])) < 1e-4
            assert abs(out["grad_norm"] - float(m1["grad_norm"])) <= \
                1e-5 * float(m1["grad_norm"])
            assert sorted(out["params"]) == sorted(want)
            for key, got in out["params"].items():
                np.testing.assert_allclose(got, want[key], atol=2e-5,
                                           err_msg=key)
        # the masters really are sharded: TP over "model", DP on the batch
        placements = tp_world[0]["native"]["placements"]
        assert tp_world[0]["over_all_reduce"]["placements"] == placements
        assert any("Shard" in p for p in placements.values())
        assert placements["embed"] == "(Replicate(), Shard(dim=0))"

    def test_sharded_step_matches_the_ports_single_device_step(self,
                                                               tp_world):
        cfg = W.get_config(W.TRAIN_ARCH)
        tp = init_params(cfg, 0, CPU, masters=True)
        batch = {k: torch.from_numpy(v)
                 for k, v in W.train_batch(cfg).items()}
        p, _, m = make_train_step(cfg, OptConfig(**W.OPT))(
            tp, init_train_state(cfg, tp), batch)
        got = tp_world[1]["native"]
        assert abs(got["loss"] - float(m["loss"])) <= 1e-6 * float(m["loss"])
        for key, leaf in named_leaves(p):
            np.testing.assert_allclose(got["params"][key],
                                       leaf.detach().numpy(), atol=2e-5,
                                       err_msg=key)

    def test_collectives_over_all_reduce_match_dtensors_own(self,
                                                            tp_world):
        """The all-reduce route of a gloo world of CUDA ranks gives the
        step DTensor's own collectives give, on every rank."""
        for out in tp_world:
            a, b = out["native"], out["over_all_reduce"]
            assert a["loss"] == b["loss"]
            assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-6)
            for key, want in a["params"].items():
                np.testing.assert_allclose(b["params"][key], want,
                                           atol=1e-6, err_msg=key)

    def test_moe_expert_parallel_matches(self, tp_world):
        from dataclasses import replace

        jcfg = replace(j_get_config(W.MOE_ARCH), capacity_factor=8.0)
        tp = init_params(W.moe_config(), 0, CPU)
        jp = jax.tree.map(jnp.asarray, reference_tree(tp))
        toks = jnp.asarray(W.moe_tokens(jcfg))
        ref = np.asarray(JM.forward(jp, toks, jcfg))
        for out in tp_world:
            np.testing.assert_allclose(ref, out["moe"], atol=3e-4)
        for out in tp_world[1:]:              # one result on every rank
            np.testing.assert_array_equal(out["moe"], tp_world[0]["moe"])


class TestGradCompression:
    def test_bf16_allreduce_and_numerics(self, dp_world):
        _, outs = dp_world
        for out in outs:
            assert out["f32_dtypes"] == ["float32"]
            assert out["bf16_dtypes"] == ["bfloat16"]
            for step in out["steps"]:
                assert step["dtypes"] == ["bfloat16"]
            np.testing.assert_allclose(out["f32"], out["bf16"], atol=1e-2,
                                       rtol=2e-2)
        # the toy gradient: f32 mean over the 4 shards = the full batch's
        # gradient / 4 (each shard's loss is its own sum)
        rng = np.random.default_rng(0)
        w = (rng.standard_normal((256, 256)) * 0.05).astype(np.float32)
        x = rng.standard_normal((32, 256)).astype(np.float32)
        full = W._toy_grad(torch.from_numpy(w), torch.from_numpy(x))
        np.testing.assert_allclose(outs[0]["f32"], full.numpy() / 4,
                                   rtol=1e-5, atol=1e-6)

    def test_compressed_step_matches_the_f32_step(self, dp_world):
        """Two compressed steps against the port's single-device f32
        steps on the whole batches, update for update."""
        _, outs = dp_world
        cfg = W.get_config(W.TRAIN_ARCH)
        opt = OptConfig(**W.COMP_OPT)
        params = init_params(cfg, 0, CPU, masters=True)
        state = init_train_state(cfg, params)
        step = make_train_step(cfg, opt)
        want, moments = [], []
        for s in range(W.COMP_STEPS):
            batch = {k: torch.from_numpy(v) for k, v in
                     W.train_batch(cfg, seed=s).items()}
            params, state, metrics = step(params, state, batch)
            want.append({k: p.detach().numpy().copy()
                         for k, p in named_leaves(params)})
            moments.append(dict(
                m={k: m.numpy().copy() for k, m in named_leaves(state["m"])},
                lr=float(metrics["lr"]),
                scale=min(1.0, opt.grad_clip / float(metrics["grad_norm"]))))
        for out in outs:
            _check_updates([st["params"] for st in out["steps"]], want,
                           moments, outs, "f32 step")
        for out in outs[1:]:                  # replicas stay identical
            for s in range(W.COMP_STEPS):
                for key, p in out["steps"][s]["params"].items():
                    np.testing.assert_array_equal(
                        p, outs[0]["steps"][s]["params"][key])

    def test_compressed_step_matches_the_reference(self, dp_world,
                                                   jax_compressed):
        """Two compressed steps against the JAX package's
        ``make_compressed_train_step`` on 4 devices from the same
        parameters and per-rank batches: rank 0's loss, the lr and the
        grad norm of the reduced gradients, and the updates."""
        _, outs = dp_world
        opt = JOptConfig(**W.COMP_OPT)
        for s, ref in enumerate(jax_compressed):
            got = outs[0]["steps"][s]
            assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
            assert ref["grad_norm"] == pytest.approx(got["grad_norm"],
                                                     rel=1e-4)
        moments = [dict(m=ref["m"], lr=ref["lr"],
                        scale=min(1.0, opt.grad_clip / ref["grad_norm"]))
                   for ref in jax_compressed]
        for out in outs:
            _check_updates([st["params"] for st in out["steps"]],
                           [ref["params"] for ref in jax_compressed],
                           moments, outs, "reference")

    def test_error_feedback_is_the_rounding_residual(self, dp_world):
        """Each rank's carried err is, bit for bit, what rounding its
        gradient plus the err it carried in to bf16 left over."""
        _, outs = dp_world
        for rank, out in enumerate(outs):
            for s in range(W.COMP_STEPS):
                inputs = _rank_inputs([out], s)[0]
                for key, g in inputs["grads"].items():
                    x = torch.from_numpy(g) + torch.from_numpy(
                        inputs["err_in"][key])
                    want = x - x.to(torch.bfloat16).to(torch.float32)
                    np.testing.assert_array_equal(
                        out["steps"][s]["err"][key], want.numpy(),
                        err_msg=f"rank {rank} step {s} {key}")

    def test_gather_over_all_reduce_is_bitwise(self, dp_world):
        _, outs = dp_world
        want = W.GATHER_PROBE.view(torch.int32).numpy()
        for out in outs:
            np.testing.assert_array_equal(out["gathered_bits"], want)

    def test_bf16_gather_over_all_reduce_is_bitwise(self, dp_world):
        """16-bit entries travel two to an int32 word: -0.0 and NaN
        patterns come back whole."""
        _, outs = dp_world
        want = W.GATHER_PROBE.to(torch.bfloat16).view(torch.int16).numpy()
        for out in outs:
            np.testing.assert_array_equal(out["gathered_bits_bf16"], want)

    def test_all_to_all_over_all_reduce_is_bitwise(self, dp_world):
        """The MoE layer's all-to-all of rows with split sizes, as
        ``gloo_collectives_over_all_reduce`` runs it (an all-reduce of
        the split sizes, then the gather over all-reduces), returns
        gloo's own all-to-all bit for bit, uneven splits, -0.0 and NaN
        patterns included."""
        _, outs = dp_world
        for rank, out in enumerate(outs):
            assert out["all_to_all_bits"].size
            np.testing.assert_array_equal(out["all_to_all_bits_routed"],
                                          out["all_to_all_bits"],
                                          err_msg=f"rank {rank}")


class TestElasticRestore:
    def test_save_on_4_restore_on_2(self, dp_world):
        ckpt, _ = dp_world
        outs = spawn(W.restore, _cpu_mesh((2,), ("data",)), ckpt)
        w = np.arange(64.0).reshape(8, 8)
        b = np.arange(16, dtype=np.float32)
        for rank, out in enumerate(outs):
            assert out["step"] == 1
            np.testing.assert_array_equal(out["full"]["w"], w)
            np.testing.assert_array_equal(out["full"]["b"], b)
            assert out["dtypes"] == {"w": "torch.float32",
                                     "b": "torch.bfloat16"}
            assert out["placements"] == {"w": "(Shard(dim=0),)",
                                         "b": "(Shard(dim=0),)"}
            np.testing.assert_array_equal(out["local"]["w"].numpy(),
                                          w[rank * 4:(rank + 1) * 4])
            assert torch.equal(out["local"]["b"], torch.arange(
                rank * 8, rank * 8 + 8, dtype=torch.bfloat16))

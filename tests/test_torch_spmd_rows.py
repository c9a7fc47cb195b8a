"""The TP train step's attention rows on a (2, 2) ("data", "model")
world of 4 gloo CPU ranks (rank function
``torch_spmd_workers.attention_rows``; ROADMAP C15).

The flash route places q, k and v as the JAX package's rules do
(``launch/sharding.py::logical_rules``), whatever placements they
arrive with: the batch of 4 rows over "data", which divides it, and the
heads over "model".  So each rank attends its own 2 rows and half the
heads, and no "data" rank attends the other's rows.  The step's loss
and every gradient leaf stay within 1e-5 of the single-device step's
(f32).

Run as a script, it prints each attention call's placements on rank 0
for the port that the import path finds first, so that two checkouts
compare under one torch:

    PYTHONPATH=src python tests/test_torch_spmd_rows.py
    PYTHONPATH=build/parent/src python tests/test_torch_spmd_rows.py
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_spmd_workers as W  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh, spawn  # noqa: E402
from repro_torch.models.common import named_leaves  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

TOL = 1e-5
ROWS_HEADS = "(Shard(dim=0), Shard(dim=1))"
pytestmark = pytest.mark.timeout(300)


def _world() -> list:
    return spawn(W.attention_rows, make_test_mesh(
        (2, 2), ("data", "model"), devices=["cpu"] * 4))


@pytest.fixture(scope="module")
def world():
    return _world()


@pytest.fixture(scope="module")
def single_device():
    out = {}
    for arch in W.ROWS_ARCHS:
        cfg = get_config(arch)
        batch = {k: torch.from_numpy(v) for k, v in
                 W.train_batch(cfg, W.PAIR_B, W.PAIR_T).items()}
        loss, grads = value_and_grad(
            init_params(cfg, 0, device="cpu", masters=True), batch, cfg)
        out[arch] = (float(loss), {k: v.detach().numpy()
                                   for k, v in named_leaves(grads)})
    return out


@pytest.mark.parametrize("arch", W.ROWS_ARCHS)
def test_attention_takes_its_rows_over_data(world, arch):
    """Every attention call of the step, on every rank, runs on q, k and
    v split by rows over "data" and by heads over "model"."""
    n_attn = get_config(arch).n_layers
    for rank, out in enumerate(world):
        calls = out[arch]["attention"]
        assert len(calls) >= n_attn, (rank, calls)
        for call in calls:
            assert call["placed"] == [ROWS_HEADS, ROWS_HEADS], (rank, call)


@pytest.mark.parametrize("arch", W.ROWS_ARCHS)
def test_step_matches_the_single_device_step(world, single_device, arch):
    """Loss within 1e-5 (relative) and each gradient leaf within 1e-5 of
    its own largest entry; a top-1 router's exact gradient is zero (its
    one gate renormalized to 1), so there both sides stay below 1e-5 of
    the other leaves' largest entry."""
    cfg = get_config(arch)
    want_loss, want = single_device[arch]
    top = max(float(np.abs(g).max()) for g in want.values())
    for rank, out in enumerate(world):
        got = out[arch]
        assert abs(got["loss"] - want_loss) <= TOL * want_loss, rank
        assert sorted(got["grads"]) == sorted(want)
        for key, g in got["grads"].items():
            if cfg.top_k == 1 and key.endswith("ffn/router"):
                assert max(float(np.abs(g).max()),
                           float(np.abs(want[key]).max())) <= TOL * top
                continue
            np.testing.assert_allclose(
                g, want[key], rtol=0,
                atol=TOL * float(np.abs(want[key]).max()),
                err_msg=f"rank {rank} {key}")


@pytest.fixture(scope="module")
def partial_world():
    return spawn(W.partial_queries, make_test_mesh(
        (2, 2), ("data", "model"), devices=["cpu"] * 4))


@pytest.mark.parametrize("route", ("native", "over_all_reduce"))
def test_partial_queries_take_their_rows_over_data(partial_world, route):
    """q arriving as partial sums over "data" (as DTensor hands
    llama4-scout's TP step its q at published widths) is summed
    into each "data" rank's own row, not into every row on every rank:
    placed (Shard(0), Shard(1)) like k and v; the output and q / k / v's
    gradients within 1e-5 of the plain attention's, on DTensor's own
    collectives and through the gloo route's all-reduces; and that
    route's all-gather takes a one-row bf16 block whose dim of one entry
    has stride 1, bit for bit."""
    from repro_torch.kernels.flash_attention.ref import mha_ref

    for rank, out in enumerate(partial_world):
        inputs = {k: torch.from_numpy(v) for k, v in out["inputs"].items()
                  if k != "odd"}
        q, k, v = (inputs[n].requires_grad_() for n in ("q", "k", "v"))
        want = mha_ref(q, k, v, causal=True)
        grads = torch.autograd.grad((want * inputs["w"]).sum(), (q, k, v))
        got = out[route]
        assert [c["arrived"][0] for c in got["attention"]] == [
            "(Partial(sum), Shard(dim=1))"], rank
        assert [c["placed"] for c in got["attention"]] == [
            [ROWS_HEADS, ROWS_HEADS]], rank
        np.testing.assert_allclose(got["out"], want.detach().numpy(),
                                   rtol=0, atol=TOL)
        for g, ref in zip(got["grads"], grads):
            np.testing.assert_allclose(g, ref.numpy(), rtol=0, atol=TOL)
        np.testing.assert_array_equal(got["gathered"],
                                      np.concatenate(out["inputs"]["odd"]))


if __name__ == "__main__":
    import repro_torch

    print(f"torch {torch.__version__}, port {repro_torch.__file__}")
    for arch, out in _world()[0].items():
        print(json.dumps({"arch": arch, "loss": out["loss"],
                          "attention": out["attention"]}))

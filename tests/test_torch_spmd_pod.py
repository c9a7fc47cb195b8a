"""Batch-1 routes on a 3-axis CPU world: ("pod", "data", "model") =
(2, 1, 2), 4 gloo ranks (rank functions in
``torch_spmd_workers.pod_routes``).

A batch of one leaves "pod" (and here "data", of one rank) free.  The
JAX package's rules give the attention heads to "model"
(``launch/sharding.py::logical_rules``), so the two "model" ranks of a
pod attend different q heads and the two "pod" ranks repeat each
other's; the decode blocks settle the residual stream where their
forwards do, so no block takes a partial sum.  Each route is held
against the same step on plain tensors (within 1e-5, f32), and the
hybrid's decode against the JAX package's.
"""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_spmd_workers as W  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh, spawn  # noqa: E402
from repro_torch.launch.roofline import COLLECTIVE_OPS  # noqa: E402

TOL = 1e-5
ROUTES = (*W.POD_DECODE_ARCHS, "prefill")


@pytest.fixture(scope="module")
def world():
    return spawn(W.pod_routes, make_test_mesh(
        W.POD_MESH, W.POD_AXES, devices=["cpu"] * int(np.prod(W.POD_MESH))))


def _position(rank: int) -> tuple:
    """(pod, data, model) of ``rank``."""
    return tuple(int(i) for i in np.unravel_index(rank, W.POD_MESH))


@pytest.mark.parametrize("arch", W.POD_DECODE_ARCHS)
def test_batch1_decode_matches_the_single_device_step(world, arch):
    """Each decode step's logits, from a seeded cache past the local
    layers' windows, and every cache after the last step."""
    for out in world:
        got = out[arch]
        assert len(got["logits"]) == W.POD_STEPS
        for a, b in zip(got["logits"], got["want"]):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        assert len(got["cache"]) == len(got["want_cache"])
        for a, b in zip(got["cache"], got["want_cache"]):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_batch1_prefill_matches_the_single_device_forward(world):
    """granite-8b-smoke's TP prefill of one row: 4 q / 2 kv heads split
    over "model"."""
    for out in world:
        got = out["prefill"]
        np.testing.assert_allclose(got["logits"], got["want"], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("route", [r for r in ROUTES
                                   if r != "falcon-mamba-7b-smoke"])
def test_model_ranks_split_the_heads_and_pod_ranks_repeat_them(world,
                                                               route):
    """Each kernel call of a rank takes 2 of the 4 q heads: the two
    "model" ranks of a pod take different ones, both together every
    head, and the two "pod" ranks of a "model" rank the same ones."""
    heads = {_position(r): out[route]["heads"] for r, out in enumerate(world)}
    calls = world[0][route]["calls"]
    assert calls[0] == calls[1] > 0
    for (pod, _, model), per_call in heads.items():
        assert len(per_call) == calls[0]
        other = heads[(pod, 0, 1 - model)]
        twin = heads[(1 - pod, 0, model)]
        for mine, theirs, same in zip(per_call, other, twin):
            assert len(mine) == 2 and -1 not in mine
            assert sorted(mine + theirs) == [0, 1, 2, 3]
            assert mine == same


@pytest.mark.parametrize("arch", W.POD_DECODE_ARCHS)
def test_decode_stream_enters_every_block_settled(world, arch):
    """The residual stream entering each decode block, and leaving the
    last for the head, is whole on every rank: no ``Partial``."""
    n_blocks = get_config(arch).n_layers
    for out in world:
        streams = out[arch]["streams"]
        assert len(streams) == W.POD_STEPS * (n_blocks + 1)
        assert set(streams) == {"(Replicate(), Replicate(), Replicate())"}


def _collectives(out) -> Counter:
    return Counter((op, size) for op, size in out["collectives"]
                   if op != "_wrap_tensor_autograd")


def test_mamba_decode_moves_the_stream_sums_and_one_all_to_all(world):
    """falcon-mamba-7b-smoke (3 layers, d 128, d_inner 256, dt_rank 8,
    state 16, f32), a step: the lookup's and each ``out_proj``'s
    all-reduce of the (1, 128) stream, each ``x_proj``'s of its (1, 40)
    sum, and one all-to-all of a rank's (1, 256) columns of
    ``in_proj``'s product, which places both halves; nothing is
    gathered."""
    steps, layers = W.POD_STEPS, 3
    assert _collectives(world[0]["falcon-mamba-7b-smoke"]) == Counter({
        ("all_reduce", 128 * 4): steps * (layers + 1),
        ("all_reduce", 40 * 4): steps * layers,
        ("all_to_all_single", 256 * 4): steps * layers})


def test_rglru_decode_reduce_scatters_its_gates(world):
    """recurrentgemma-9b-smoke (4 layers: three RG-LRU, one local
    attention; lru width 64, f32), a step: each RG-LRU gate's partial
    sums reduce-scattered to the rank's 32 channels, one all-reduce of
    the (1, 128) stream a row-split product and the lookup's, and the
    one kv head's k and v (1, 32) gathered, since 2 ranks cannot split
    it."""
    steps = W.POD_STEPS
    assert _collectives(world[0]["recurrentgemma-9b-smoke"]) == Counter({
        ("reduce_scatter_tensor", 32 * 4): steps * 3 * 2,
        ("all_reduce", 128 * 4): steps * (4 * 2 + 1),
        ("all_gather_into_tensor", 32 * 4): steps * 2})


def test_no_unkeyed_argument_shapes_a_dtensor_op(world):
    """``test_torch_spmd_decode.py``'s audit over these routes: every
    non-tensor argument of their DTensor ops that DTensor's sharding
    cache leaves out of its key is one no output's shape depends on."""
    for rank, out in enumerate(world):
        unkeyed = {tuple(a) for a in out["unkeyed"]}
        assert unkeyed <= set(W.SHAPELESS_UNKEYED), \
            (rank, sorted(unkeyed - set(W.SHAPELESS_UNKEYED)))


def test_pod_decode_matches_the_jax_package(world):
    """recurrentgemma-9b-smoke's decode on the pod mesh from zeroed
    caches, held against the JAX package's ``decode_step`` on the same
    parameters (the port's seed-0 draws carried over), within 1e-3
    (``test_torch_model_families.py``'s tolerance)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.models import model as JM
    from repro.models.decoder import init_cache as j_init_cache
    from repro_torch.models.model import init_params
    from torch_train_parity import reference_tree

    cfg = get_config(W.POD_JAX_ARCH)
    jcfg = j_get_config(W.POD_JAX_ARCH)
    jp = jax.tree.map(jnp.asarray,
                      reference_tree(init_params(cfg, 0, device="cpu")))
    jc = j_init_cache(jcfg, 1, W.POD_JAX_SLOTS)
    toks = W.pod_tokens(cfg, W.POD_JAX_STEPS)
    step = jax.jit(JM.decode_step, static_argnames="cfg")
    want = []
    for i in range(W.POD_JAX_STEPS):
        lg, jc = step(jp, jc, toks[:, i:i + 1], i, cfg=jcfg)
        want.append(np.asarray(lg))
    for out in world:
        assert len(out["from_zero"]) == W.POD_JAX_STEPS
        for got, ref in zip(out["from_zero"], want):
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# the decode blocks where "data" splits the batch (and FSDP the weights)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def batch_world():
    return spawn(W.batch_decode, make_test_mesh((2, 2), ("data", "model"),
                                                devices=["cpu"] * 4))


def test_moe_decode_of_one_row_matches_the_single_device_step(batch_world):
    """llama4-scout-17b-a16e-smoke decoding one row on the (2, 2) mesh,
    whose "data" cannot split it: each "data" rank multiplies the row
    over its half of d in the router, one "model" rank of each takes the
    row and the other none, and the MoE layer's reduce-scatter of the
    row's expert outputs over "model" leaves one rank no rows to sum
    (``ffn._choice_sum`` of none); logits and caches within 1e-5 (f32)."""
    for out in batch_world:
        got = out["moe_one_row"]
        np.testing.assert_allclose(got["logits"], got["want"], rtol=TOL,
                                   atol=TOL)
        assert len(got["cache"]) == len(got["want_cache"])
        for a, b in zip(got["cache"], got["want_cache"]):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", W.BATCH_DECODE_ARCHS)
def test_batch_decode_matches_the_single_device_step(batch_world, arch):
    """A decode step of 4 rows on the (2, 2) ("data", "model") mesh:
    MLA's output projection summed to the stream's rows and its latent
    down-projections split over "model" (deepseek-v2-236b-smoke), the
    MoE layers fed from a settled stream, Mamba's in-projection halves
    by an all-to-all on each rank's rows, RG-LRU's gates
    reduce-scattered; logits and caches within 1e-5 (f32), and the
    stream entering each block split by rows only.

    Each "model" rank of deepseek-v2-236b-smoke multiplies 2 of the
    "data" group's 4 rows over its "data" rank's half of d (ROADMAP
    C16): every collective of a latent (q_down's 48 columns, kv_down's
    32 + 16) is an all-reduce of (2, 1, 48), the partial sums over
    "data" and then each rank's own rows over "model", two a
    down-projection and MLA layer; none sums a partial product of all 4
    rows (the reduce-scatter of (4, 1, 48) partials to (2, 1, 48) that
    had each "model" rank repeat its "data" block's whole product)."""
    cfg = get_config(arch)
    n_blocks = cfg.n_layers
    if cfg.kv_lora_rank:
        widths = {cfg.q_lora_rank, cfg.kv_lora_rank + cfg.qk_rope_dim}
        for out in batch_world:
            latents = [(op, shape) for op, shape
                       in out[arch]["collective_shapes"]
                       if op in COLLECTIVE_OPS and len(shape) == 3
                       and shape[-1] in widths]
            assert len(latents) == 4 * n_blocks, latents
            assert {(op, shape[0]) for op, shape in latents} == {
                ("all_reduce", W.DECODE_B // 2)}, latents
    for out in batch_world:
        got = out[arch]
        np.testing.assert_allclose(got["logits"], got["want"], rtol=TOL,
                                   atol=TOL)
        assert len(got["cache"]) == len(got["want_cache"])
        for a, b in zip(got["cache"], got["want_cache"]):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        assert len(got["streams"]) == n_blocks + 1
        assert set(got["streams"]) == {"(Shard(dim=0), Replicate())"}

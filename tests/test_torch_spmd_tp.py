"""The tensor-parallel train step's autograd pair (``models/common.py``:
``copy_to_model`` at the input of column-parallel products,
``reduce_from_model`` after row-parallel ones) in spawned gloo worlds of
CPU ranks, against the port's single-device step.

Two worlds, each started by ``repro_torch.launch.mesh.spawn`` with
``torch_spmd_workers.tp_pair``: 2 ranks over ("model",), as phase M's
M2 splits granite-8b on the card, and 2 x 2 over ("data", "model").  In
each, six ``-smoke`` configs (dense GQA, GQA over one kv head, Mamba,
RG-LRU with local attention, MLA with the routed MoE at top 2, then
attention with the routed MoE at top 1 over as many experts) take one
loss and gradient on masters and a batch placed by the sharding rules.
The limits are M2's: the loss within 2e-4 of the single-device loss
(relative), the gradient norm within 1e-3 (relative); each gradient
leaf is held within 1e-3 of its own largest entry, but for a top-1
router's, whose exact gradient is zero: there both are held below 1e-6
of the gradient norm.  No all-reduce of the step is as large as a
rank's vocab share of the f32 logits, over ("model",): the logits stay
split by vocab, and the stream's all-reduces move (rows, T, d_model).
No argument that DTensor's sharding cache leaves out of its key shapes
an op's output, in the step or in the MoE configs' TP prefill, and no
op of the step is an accumulating scatter on a DTensor (ROADMAP C10).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_spmd_workers as W  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh, spawn  # noqa: E402
from repro_torch.models.common import named_leaves  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

# phase M's M2 limits (chip_smoke.M_LOSS_RTOL, M_GNORM_RTOL)
LOSS_RTOL, GNORM_RTOL = 2e-4, 1e-3
pytestmark = pytest.mark.timeout(300)

WORLDS = {"model2": ((2,), ("model",)),
          "data2_model2": ((2, 2), ("data", "model"))}


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request):
    shape, axes = WORLDS[request.param]
    mesh = make_test_mesh(shape, axes,
                          devices=["cpu"] * int(np.prod(shape)))
    return request.param, spawn(W.tp_pair, mesh)


@pytest.fixture(scope="module")
def single_device():
    out = {}
    for arch in W.PAIR_ARCHS:
        cfg = get_config(arch)
        params = init_params(cfg, 0, device="cpu", masters=True)
        batch = {k: torch.from_numpy(v) for k, v in
                 W.train_batch(cfg, W.PAIR_B, W.PAIR_T).items()}
        loss, grads = value_and_grad(params, batch, cfg)
        out[arch] = (float(loss), {k: v.detach().numpy()
                                   for k, v in named_leaves(grads)})
    return out


def _zero_gradient(cfg, key: str) -> bool:
    """A top-1 router's exact gradient is zero: its one gate is
    renormalized to v / v = 1."""
    return cfg.top_k == 1 and key.endswith("ffn/router")


def _norm(grads) -> float:
    return math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                         for g in grads.values()))


def _assert_step_matches(got, want_loss, want, arch, where):
    """A rank's loss and gradients against the single-device step's, at
    M2's limits and the per-leaf rule above."""
    assert abs(got["loss"] - want_loss) <= LOSS_RTOL * want_loss, where
    assert abs(_norm(got["grads"]) - _norm(want)) <= \
        GNORM_RTOL * _norm(want), where
    assert sorted(got["grads"]) == sorted(want)
    for key, g in got["grads"].items():
        if _zero_gradient(get_config(arch), key):
            # both sides are rounding: far below the step's norm
            assert max(float(np.abs(g).max()), float(np.abs(
                want[key]).max())) <= 1e-6 * _norm(want), (where, key)
            continue
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(g, want[key], rtol=0,
                                   atol=GNORM_RTOL * scale,
                                   err_msg=f"{where} {key}")


@pytest.mark.parametrize("arch", W.PAIR_ARCHS)
def test_tp_step_matches_the_single_device_step(world, single_device, arch):
    name, ranks = world
    want_loss, want = single_device[arch]
    for rank, out in enumerate(ranks):
        _assert_step_matches(out[arch], want_loss, want, arch,
                             f"{name} rank {rank}")


@pytest.mark.parametrize("feed", W.FEEDS)
@pytest.mark.parametrize("arch", W.PAIR_MOE_ARCHS)
def test_each_moe_feed_matches_the_single_device_step(world, single_device,
                                                      arch, feed):
    """The MoE configs' step with the expert groups fed each way
    (``ffn._slot_blocks``, ``ffn._embed_blocks``; which one a layer takes
    follows the sizes, and these rows pick embed blocks), loss and every
    gradient leaf at the limits above.  On the (2, 2) world slot blocks
    send each entry to the "data" rank of its capacity row by an
    all-to-all and back, and multiply the group's weights gathered over
    FSDP's "data", whose gradient each rank holds for its own capacity
    rows only (a partial sum over "data"); embed blocks reduce-scatter
    the group's capacity by d and sum f32 partial products.  The (2,)
    world's FSDP splits no expert weight, so slot blocks run there
    either way."""
    name, ranks = world
    want_loss, want = single_device[arch]
    for rank, out in enumerate(ranks):
        got = out[arch]["feeds"][feed]
        assert got["fed"] == [feed if name == "data2_model2" else "slot"], \
            (name, rank, got["fed"])
        _assert_step_matches(got, want_loss, want, arch,
                             f"{name} rank {rank} {feed}")


@pytest.mark.parametrize("arch", W.PAIR_ARCHS)
def test_the_pair_carries_the_step(world, arch):
    """Both backwards of the pair run in every step.  Over ("model",)
    alone, where no weight's gradient is summed over a data dim, the
    largest all-reduce is below a rank's vocab share of f32 logits
    (rows x T x V / 2 x 4 bytes): no rank sums the logits of the whole
    vocab (rows x T x V x 4)."""
    name, ranks = world
    vocab_share = W.PAIR_B * W.PAIR_T * get_config(arch).vocab_size // 2 * 4
    for out in ranks:
        got = out[arch]
        assert got["calls"]["copy_to_model"] > 0
        assert got["calls"]["reduce_from_model"] > 0
        sizes = [n for op, n in got["collectives"] if op == "all_reduce"]
        assert sizes
        if name == "model2":
            assert max(sizes) < vocab_share, max(sizes)


@pytest.mark.parametrize("arch", W.PAIR_ARCHS)
def test_no_unkeyed_argument_shapes_a_dtensor_op(world, arch):
    """DTensor reuses a cached sharding decision, output shape included,
    for calls that differ only in arguments its key leaves out; each
    such argument the step passes is one that no output's shape depends
    on (torch 2.13's registrations; the table holds 2.11's too)."""
    name, ranks = world
    for rank, out in enumerate(ranks):
        unkeyed = {tuple(a) for a in out[arch]["unkeyed"]}
        assert unkeyed <= set(W.SHAPELESS_UNKEYED), \
            (name, rank, sorted(unkeyed - set(W.SHAPELESS_UNKEYED)))


@pytest.mark.parametrize("arch", W.PAIR_ARCHS)
def test_no_dtensor_scatter_accumulates(world, arch):
    """No op of the step is an accumulating ``index_put`` on a DTensor:
    the card's DTensor (torch 2.11) placed the one that was the backward
    of ``combine``'s inverse-permutation gather with its values split by
    rows over "data" and its indices whole, and the MoE configs' step
    failed its backward on the (2, 2) mesh (ROADMAP C10).  The MoE
    FFN's moves are gathers and scatters with unique indices whose
    backwards are again gathers and scatters (``models/ffn.py``)."""
    name, ranks = world
    for rank, out in enumerate(ranks):
        assert out[arch]["accumulating"] == [], (name, rank)


@pytest.mark.parametrize("arch", W.PAIR_ARCHS)
def test_the_head_sums_no_partial_logits(world, arch):
    """The head's product comes out split by rows and by vocab, never a
    partial sum: an embedding dim that FSDP splits over "data" (the MoE
    configs) is gathered on use, where DTensor had left the product's
    contraction split and summed (B, T, V) partial logits over "data",
    which on the card's torch all-gathered f32 logits of every row and
    the whole vocab (ROADMAP C11)."""
    name, ranks = world
    for rank, out in enumerate(ranks):
        heads = out[arch]["head"]
        assert heads and not any("Partial" in h for h in heads), \
            (name, rank, heads)


@pytest.mark.parametrize("arch", W.PAIR_MOE_ARCHS)
def test_moe_bf16_output_rounds_once(world, arch):
    """``moe_forward`` in bf16 on DTensors, as training runs it, within
    one bf16 ulp of the largest |out| of the single-device one.  Where
    FSDP splits the experts' contraction over "data", the partial
    products are summed in f32 and rounded once, as one device rounds
    its f32 sum once (ROADMAP C11); bf16 partials rounded apiece were 2
    ulps off here, and 3 on the card at published widths."""
    name, ranks = world
    for rank, out in enumerate(ranks):
        got = out[arch]["ffn_bf16"]
        top = float(np.abs(got["want"]).max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        err = float(np.abs(got["got"] - got["want"]).max())
        assert err <= ulp, (name, rank, err / ulp)


@pytest.mark.parametrize("arch", W.PAIR_MOE_ARCHS)
def test_tp_prefill_matches_and_keys_its_shapes(world, arch):
    """The MoE configs' prefill on DTensors (``forward`` under no_grad,
    the dry run's prefill route) against the same forward on plain
    tensors, logits within 1e-5 (f32), and every argument that
    DTensor's sharding cache leaves out of its key in the table."""
    name, ranks = world
    for rank, out in enumerate(ranks):
        got = out[arch]["prefill"]
        np.testing.assert_allclose(got["logits"], got["want"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"{name} rank {rank}")
        unkeyed = {tuple(a) for a in got["unkeyed"]}
        assert unkeyed <= set(W.SHAPELESS_UNKEYED), \
            (name, rank, sorted(unkeyed - set(W.SHAPELESS_UNKEYED)))


def _capacity(cfg, s: int) -> int:
    """The expert capacity of ``s`` rows, as ``ffn.route`` counts it."""
    return min(s, int((s * cfg.top_k / cfg.n_experts)
                      * cfg.capacity_factor) + 1)


@pytest.mark.parametrize("arch", W.PAIR_MOE_ARCHS)
def test_moe_layer_gathers_no_expert_rows_or_tokens(world, arch):
    """No collective of the MoE configs' TP MoE layer, forward and
    backward in bf16 as training runs it, has a result shaped as every
    expert's capacity rows, (E * C, d) or (E, C, d), and on the (2, 2)
    world, whose ranks hold half the rows, none shaped as the step's
    rows, (B * T, d) or (B, T, d): each rank keeps the entries of its
    own rows that go to its expert group, and each row's contributions
    are summed on one rank of "model"; the shared expert's FSDP-split
    weights are gathered on use.  Reading every expert's output back at
    each entry's slot had gathered the (E * C, d) rows on every rank,
    and the shared expert the step's rows (ROADMAP C12)."""
    name, ranks = world
    cfg = get_config(arch)
    s, d = W.PAIR_B * W.PAIR_T, cfg.d_model
    cap = _capacity(cfg, s)
    banned = {(cfg.n_experts * cap, d), (cfg.n_experts, cap, d)}
    if name == "data2_model2":
        banned |= {(s, d), (W.PAIR_B, W.PAIR_T, d)}
    for rank, out in enumerate(ranks):
        shapes = [(op, tuple(shape)) for op, shape
                  in out[arch]["ffn_bf16"]["collective_shapes"]]
        assert shapes, (name, rank)
        assert not [c for c in shapes if c[1] in banned], \
            (name, rank, sorted({c for c in shapes if c[1] in banned}))

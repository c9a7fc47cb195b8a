"""The sharded decode step on CPU ranks: a decode over a cache placed
by ``cache_shardings`` (DTensor on every rank of a gloo world of
("data", "model") = (2, 2) or (1, 4)) against the same step on plain
tensors.  Where "model" cannot split the kv heads, its ranks split the
q heads within one kv head's group (``kernels/decode_attention/ops.py``).  The JAX
package runs no sharded decode (its dry run only compiles one), so the
port's own single-device step is the reference.  The same worlds run
the routes where two ranks share each kv head (``W.split_routes``):
decode over key shards, the forward and a train step's gradients over
zig-zag query chunks, and the vocab-parallel lookup; the single-device
step of their configs is held against the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_spmd_workers as W  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh, spawn  # noqa: E402


MESHES = {"2x2": (2, 2), "1x4": (1, 4)}


@pytest.fixture(scope="module", params=sorted(MESHES))
def world(request):
    shape = MESHES[request.param]
    return request.param, spawn(W.sharded_decode, make_test_mesh(
        shape, ("data", "model"), devices=["cpu"] * (shape[0] * shape[1])))


@pytest.mark.parametrize("arch", W.DECODE_ARCHS)
def test_sharded_decode_matches_the_single_device_step(world, arch):
    """Logits and the updated caches within 1e-5 (f32): the products
    whose inner dim "model" splits sum their parts in another order.
    On 2 x 2 granite-8b-smoke's kv heads split over "model"; on 1 x 4
    neither config's can, and each rank decodes its q head against the
    kv head of its group (granite-8b-smoke: ranks 0-1 head 0, 2-3 head
    1)."""
    name, outs = world
    for out in outs:
        got = out[arch]
        np.testing.assert_allclose(got["logits"], got["want"], rtol=1e-5,
                                   atol=1e-5)
        assert len(got["cache"]) == len(got["want_cache"])
        for a, b in zip(got["cache"], got["want_cache"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    placements = outs[0][arch]["k_placements"]
    assert "Shard(dim=0)" in placements          # the batch over "data"
    heads_split = name == "2x2" and arch == "granite-8b-smoke"
    assert ("Shard(dim=1)" in placements) == heads_split


def test_no_unkeyed_argument_shapes_a_dtensor_op(world):
    """DTensor reuses a cached sharding decision, output shape included,
    for calls that differ only in arguments its key leaves out; each
    such argument that the decode routes and the split routes pass (the
    sharded decode, the key- and slot-split decode, the zig-zag forward
    and gradients, the vocab-parallel lookup) is one that no output's
    shape depends on (``W.SHAPELESS_UNKEYED``, as for the train step)."""
    name, outs = world
    for rank, out in enumerate(outs):
        unkeyed = {tuple(a) for a in out["unkeyed"]}
        assert unkeyed <= set(W.SHAPELESS_UNKEYED), \
            (name, rank, sorted(unkeyed - set(W.SHAPELESS_UNKEYED)))


# ---------------------------------------------------------------------------
# the routes where several ranks share a kv head
# ---------------------------------------------------------------------------
def _split(world):
    name, outs = world
    return name, [out["split"] for out in outs]


@pytest.mark.parametrize("batch", [W.DECODE_B, 1])
def test_key_split_decode_matches_the_single_device_step(world, batch):
    """``W.split_config``: "model" cannot split its kv heads, so the two
    ranks that share each attend half its keys and the halves merge by
    their log-sum-exps; at batch 1 the cache's slots are also split over
    "data" (the sequence-parallel cache), merged over both mesh dims,
    and the full rolling window caches roll across the slot shards.
    Logits and caches within 1e-5 (f32)."""
    _, outs = _split(world)
    for out in outs:
        got = out[f"decode_{batch}"]
        np.testing.assert_allclose(got["logits"], got["want"], rtol=1e-5,
                                   atol=1e-5)
        assert len(got["cache"]) == len(got["want_cache"])
        for a, b in zip(got["cache"], got["want_cache"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    placements = outs[0][f"decode_{batch}"]["k_placements"]
    assert "Shard(dim=1)" not in placements
    # at batch 1 the slots split over "data" (of one rank on 1 x 4)
    assert ("Shard(dim=2)" in placements) == (batch == 1)


def test_query_chunks_forward_and_gradients_match_the_single_device_step(
        world):
    """The forward and the loss and gradients of a train step of
    ``W.split_config``, whose queries split in zig-zag chunks over the
    two ranks of each kv head (the local layers' windows start inside a
    chunk): logits, loss and every gradient within 1e-5 (f32)."""
    _, outs = _split(world)
    for out in outs:
        fwd, train = out["forward"], out["train"]
        np.testing.assert_allclose(fwd["got"], fwd["want"], rtol=1e-5,
                                   atol=1e-5)
        assert train["loss"] == pytest.approx(train["want_loss"], rel=1e-5)
        assert sorted(train["grads"]) == sorted(train["want_grads"])
        for key, want in train["want_grads"].items():
            np.testing.assert_allclose(train["grads"][key], want, rtol=1e-5,
                                       atol=1e-5, err_msg=key)


@pytest.mark.parametrize("spec", ["vocab", "vocab_fsdp"])
def test_vocab_parallel_lookup_matches_the_single_device_lookup(world, spec):
    """The lookup in a table split over "model" by its vocab: rows and
    their gradient within 1e-5, the gradient in each rank's own rows
    (the table's placements), and no collective but the all-reduce of
    the rows; an embedding dim split over "data" (FSDP) is gathered
    first."""
    name, outs = _split(world)
    for out in outs:
        got = out["lookup"][spec]
        np.testing.assert_allclose(got["rows"], got["want_rows"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["grad"], got["want_grad"], rtol=1e-5,
                                   atol=1e-5)
        assert "Shard(dim=0)" in got["grad_placements"]
        fsdp = spec == "vocab_fsdp" and name == "2x2"
        assert got["collectives"] == (["all_gather_into_tensor", "all_reduce"]
                                      if fsdp else ["all_reduce"])


@pytest.mark.parametrize("mesh_shape", sorted(W.SPLIT_HEADS))
def test_split_configs_forward_matches_the_jax_package(mesh_shape):
    """The single-device step that the routes above are held against,
    held against the JAX package: ``W.split_config``'s forward logits on
    carried parameters, within 1e-3 (``test_torch_models.py``'s
    tolerance)."""
    import jax
    from dataclasses import replace

    from repro.configs import get_config as j_get_config
    from repro.models import model as JM
    from repro_torch.carry import params_from_reference
    from repro_torch.models.model import forward

    cfg = W.split_config(mesh_shape)
    jcfg = replace(j_get_config(W.TRAIN_ARCH), n_heads=cfg.n_heads,
                   n_kv_heads=cfg.n_kv_heads, window=cfg.window)
    jp = JM.init_params(jcfg, 0)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = W.train_batch(cfg)["tokens"]
    want = np.asarray(JM.forward(jp, toks, jcfg))
    got = forward(tp, torch.from_numpy(toks).long(), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)

"""The sharded decode step on CPU ranks: a decode over a cache placed
by ``cache_shardings`` (DTensor on every rank of a gloo world of
("data", "model") = (2, 2) or (1, 4)) against the same step on plain
tensors.  Where "model" cannot split the kv heads, its ranks split the
q heads within one kv head's group (``kernels/decode_attention/ops.py``).  The JAX
package runs no sharded decode (its dry run only compiles one), so the
port's own single-device step is the reference.
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

"""The port's CheckpointManager: the reference tests' four cases
(round trip, keep-k GC, a crashed writer leaves no partial commit,
restore of the latest of many), bitwise round trips of bf16, int32
0-dim and ParamTree leaves into the like-tree's dtype and grad flag, the
host snapshot taken inside ``save`` (the trainer updates in place next),
and the on-disk layout the JAX package writes and reads."""
import json
import os

import numpy as np
import torch

from repro.ckpt.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.models.common import ParamTree, named_leaves
from repro_torch.models.model import init_params


def _equal_trees(a, b):
    la, lb = named_leaves(a), named_leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x.detach(), y.detach()), k


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(8.0), "b": {"c": torch.ones((2, 3))}}
    mgr.save(5, tree, blocking=True)
    step, restored = mgr.restore(tree)
    assert step == 5
    _equal_trees(tree, restored)


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=True)
    assert mgr._steps() == [3, 4]


def test_crash_leaves_no_partial_commit(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"a": torch.zeros(4)}
    mgr.save(1, tree, blocking=True)
    # simulate a crashed writer: stale tmp dir
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert mgr.latest_step() == 1
    mgr.save(3, tree, blocking=True)     # GC removes stale tmp
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_restore_latest_of_many(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in (10, 20, 30):
        mgr.save(s, {"a": torch.full((2,), float(s))}, blocking=True)
    step, tree = mgr.restore({"a": torch.zeros(2)})
    assert step == 30 and float(tree["a"][0]) == 30.0
    assert mgr.restore({"a": torch.zeros(2)}, step=10)[1]["a"][0] == 10.0
    assert CheckpointManager(str(tmp_path / "empty")).restore(
        {"a": torch.zeros(2)}) == (None, None)


def test_bf16_int_and_param_tree_leaves_roundtrip_bitwise(tmp_path):
    cfg = get_config("gemma3-1b-smoke")
    bf16 = init_params(cfg, 3, "cpu").to(torch.bfloat16)
    masters = init_params(cfg, 3, "cpu", masters=True)
    tree = {"serve": bf16, "params": masters,
            "opt": {"step": torch.tensor(41, dtype=torch.int32),
                    "odd": torch.tensor([-0.0, float("inf"), 1e-40],
                                        dtype=torch.bfloat16)}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, tree, blocking=True)
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["dtypes"]["opt/odd"] == "bfloat16"
    assert manifest["dtypes"]["params/layers/scan/0/0/mix/wq"] == "float32"
    _, back = mgr.restore(tree)
    _equal_trees(tree, back)
    assert isinstance(back["params"], ParamTree)
    assert all(p.requires_grad for _, p in named_leaves(back["params"]))
    assert not any(p.requires_grad for _, p in named_leaves(back["serve"]))
    # a like-tree in another dtype receives the values in its own dtype
    _, as_f32 = mgr.restore({**tree, "serve": bf16.float()})
    assert as_f32["serve"]["embed"].dtype == torch.float32
    assert torch.equal(as_f32["serve"]["embed"], bf16["embed"].float())


def test_save_snapshots_before_returning(tmp_path):
    """The trainer updates its tensors in place right after ``save``
    returns, while the write is still running."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.arange(1 << 16, dtype=torch.float32)
    mgr.save(1, {"w": w})
    w.add_(1.0)
    mgr.wait()
    _, back = mgr.restore({"w": w})
    assert torch.equal(back["w"], torch.arange(1 << 16,
                                               dtype=torch.float32))


def test_the_reference_reads_the_layout(tmp_path):
    """Same directory layout, manifest keys and npz keys as the JAX
    package: its manager finds and restores an f32 checkpoint."""
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2)]}
    CheckpointManager(str(tmp_path)).save(4, tree, blocking=True)
    jmgr = JCheckpointManager(str(tmp_path))
    assert jmgr.latest_step() == 4
    step, got = jmgr.restore({"a": np.zeros((2, 3), np.float32),
                              "b": [np.zeros(2, np.float32)]})
    assert step == 4
    np.testing.assert_array_equal(np.asarray(got["a"]), tree["a"].numpy())
    np.testing.assert_array_equal(np.asarray(got["b"][0]), np.ones(2))

"""The port's dry run of the MoE training cells on ``pod16x16``, and how
it counts an all-to-all (``repro_torch.launch.dryrun``).

The MoE FFN on DTensors (``models/ffn.py::_routed_on_ranks``) keeps the
step's rows split over "data" and each rank's entries with its expert
group: a rank of group j sends the entries of its own rows that go to
group j's experts to the ranks that hold their capacity rows (an
all-to-all over "data"), multiplies its block by the group's weights
(gathered over FSDP's "data" on use) and sends the outputs back; each
row's k contributions are summed on one rank of "model".  Reading every
expert's output back at each entry's slot had gathered the step's
(E * C, d) expert rows on every rank: 13,424,394,240 B (llama4-scout,
E * C = 16 x 81,921 rows of 5,120 bf16) and 80,532,275,200 B
(deepseek-v2, 160 x 49,153) a gather (ROADMAP C12).

Each cell runs in a process of its own (the fake process group belongs
to the process), the two started together, with the step counter's spy
of ``test_torch_dryrun_train.py``.  Per cell: an all-to-all is counted;
no all-gather is as large as one "model" rank's share of the expert
rows, E * C * d * 2 / 16 bytes; the flops a device stay within 1.01 of
the parent's (pinned below); the collective bytes a device fall to at
most 0.75 (llama4-scout) and 0.5 (deepseek-v2) of the parent's.

The JAX package's ``collective_bytes_per_device`` (its ``run_cell`` on
this repo's CPU, jax 0.9.0) are pinned beside them: the port's totals
after the change are 0.16 (llama4-scout, 5.09e11 against 3.14e12) and
0.13 (deepseek-v2, 7.47e11 against 5.96e12) of them, where the parent's
were 1.92 and 3.96.  The JAX ``collectives`` dict counts the scanned
layer body once, so only these totals compare.  The port's MoE
all-to-alls move the rows of a balanced route (a fake route has no
values: ``dryrun._balanced_moe_route``); the JAX package's are static
reshards.

The layer feeds an expert group by slot blocks or by embed blocks,
whichever ``ffn.feed_bytes`` counts as moving fewer bytes.  One MoE layer
of each config at each cell's rows (decode_32k, prefill_32k, train_4k
with its backward), traced on ``pod16x16`` in one process with each
feed forced, holds that model against the counter: the layer picks the
feed the counter books fewer bytes for, and the model's difference
between the two feeds is within 2% of the counter's.  ``python
tests/test_torch_dryrun_moe_split.py`` prints the counts.

DTensor's shard-to-shard redistribution on a CPU mesh all-gathers the
whole tensor and keeps a chunk; the dry run's fake world runs it as an
all-to-all, as a card's process group does (``dryrun.fake_world``).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun_train import _finish, start_train_cell  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
ARCHS = ("llama4-scout-17b-a16e", "deepseek-v2-236b")

# the parent's figures (the read-back of every expert's output):
# (flops_per_device, collective_bytes_per_device), train_4k, pod16x16
PARENT = {
    "llama4-scout-17b-a16e": (601_228_396_462_080, 6_030_203_954_188),
    "deepseek-v2-236b": (1_071_416_348_246_016, 23_589_813_413_132),
}
# the JAX package's collective_bytes_per_device, train_4k, pod16x16
JAX_COLLECTIVE_BYTES = {
    "llama4-scout-17b-a16e": 3_140_447_289_464,
    "deepseek-v2-236b": 5_962_338_122_672,
}
# at most this share of the parent's collective bytes
BYTES_RATIO = {"llama4-scout-17b-a16e": 0.75, "deepseek-v2-236b": 0.5}


def expert_rows_share(arch: str) -> int:
    """One "model" rank's share of ``train_4k``'s (E * C, d) bf16 expert
    rows on ``pod16x16``: E * C * d * 2 / 16 bytes."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    s = 256 * 4096
    cap = min(s, int((s * cfg.top_k / cfg.n_experts)
                     * cfg.capacity_factor) + 1)
    return cfg.n_experts * cap * cfg.d_model * 2 // 16


def check_split_moe(r: dict, arch: str, parent_flops: int) -> None:
    """The checks every MoE training or prefill cell of the change
    passes: the report says its all-to-all bytes are a balanced
    router's, an all-to-all, no all-gather of a model rank's share of
    the expert rows, the parent's flops within 1.01."""
    from repro_torch.launch.dryrun import BALANCED_ROUTE

    assert r["status"] == "ok", (r.get("error"), r.get("traceback"))
    assert r["moe_route"] == BALANCED_ROUTE
    assert "all-to-all" in r["collectives"], r["collectives"]
    assert r["collective_largest"]["all-gather"] < expert_rows_share(arch), \
        r["collective_largest"]
    assert r["flops_per_device"] <= 1.01 * parent_flops, \
        r["flops_per_device"] / parent_flops


@pytest.fixture(scope="module")
def train_cells():
    procs = {a: start_train_cell(a, multi_pod=False) for a in ARCHS}
    return {a: _finish(p) for a, p in procs.items()}


def test_expert_rows_shares():
    """One "model" rank's share of the expert rows, the bound on any
    all-gather of the MoE cells, from the configurations."""
    assert expert_rows_share("llama4-scout-17b-a16e") == 838_871_040
    assert expert_rows_share("deepseek-v2-236b") == 5_033_267_200


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_moves_entries_not_expert_rows(train_cells, arch):
    r = train_cells[arch]
    flops, coll = PARENT[arch]
    check_split_moe(r, arch, flops)
    assert r["collective_bytes_per_device"] <= BYTES_RATIO[arch] * coll, \
        r["collective_bytes_per_device"] / coll
    assert r["collective_bytes_per_device"] < \
        JAX_COLLECTIVE_BYTES[arch], r["collective_bytes_per_device"]


_REDISTRIBUTE = """
    import json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import device_mesh, make_test_mesh

    with D.fake_world(16):
        dmesh = device_mesh(make_test_mesh((16,), ("data",),
                                           devices=["cpu"] * 16))
        with FakeTensorMode():
            t = DTensor.from_local(torch.empty(4, 64), dmesh, [Shard(0)],
                                   run_check=False, shape=(64, 64),
                                   stride=(64, 1))
            counter = D.StepCounter()
            with counter:
                out = t.redistribute(dmesh, [Shard(1)])
            local = list(out.to_local().shape)
    print("RESULT_JSON:" + json.dumps({"collectives": counter.collectives,
                                       "local": local}))
"""


def test_fake_world_counts_shard_to_shard_as_one_all_to_all():
    """A (64, 64) f32 DTensor split by rows over 16 ranks, redistributed
    to a split by columns: one all-to-all of the local shard's 4 x 64 x
    4 bytes, no all-gather (DTensor's CPU route would gather 64 x 64)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c",
                           textwrap.dedent(_REDISTRIBUTE)],
                          capture_output=True, text=True, env=env,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "falling back with allgather" not in proc.stderr
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT_JSON:")][0]
    got = json.loads(line[len("RESULT_JSON:"):])
    assert got["collectives"] == [["all_to_all_single", 4 * 64 * 4]]
    assert got["local"] == [64, 4]


# one MoE layer's rows in each cell: (B, T, whether a gradient is taken)
FEED_CELLS = {"decode_32k": (128, 1, False), "prefill_32k": (32, 32768, False),
              "train_4k": (256, 4096, True)}

_FEEDS = f"""
    import contextlib, json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import device_mesh, make_production_mesh
    from repro_torch.launch.sharding import NamedSharding, param_shardings
    from repro_torch.models import ffn as F
    from repro_torch.models.common import (ParamTree, abstract_params,
                                           named_leaves)
    from torch_spmd_workers import forced_feed

    out = []
    with D.fake_world(256), D._balanced_moe_route():
        mesh = make_production_mesh(
            multi_pod=False, devices=[D.fake_device_type()] * 256)
        dmesh = device_mesh(mesh)
        with FakeTensorMode():
            for arch in {ARCHS}:
                cfg = get_config(arch)
                specs = F.moe_specs(cfg)
                for shape, (b, t, grad) in {FEED_CELLS}.items():
                    for feed in ("auto", "slot", "embed"):
                        p = ParamTree(D._place(
                            abstract_params(specs, torch.bfloat16),
                            param_shardings(specs, cfg, mesh), dmesh,
                            requires_grad=grad))
                        x = D.fake_dtensor(
                            torch.empty((b, t, cfg.d_model),
                                        dtype=torch.bfloat16, device="meta"),
                            NamedSharding(mesh, ("data",)), dmesh,
                            requires_grad=grad)
                        counter = D.StepCounter()
                        forced = contextlib.nullcontext([]) \\
                            if feed == "auto" else forced_feed(feed)
                        with forced, implicit_replication(), counter, \\
                                D._uncounted_propagation(counter):
                            y = F.moe_forward(p, x, cfg, torch.bfloat16)
                            if grad:
                                torch.autograd.grad(
                                    y.float().sum(),
                                    [x] + [v for _, v in named_leaves(p)])
                        out.append([arch, shape, feed, sum(
                            n for _, n in counter.collectives)])
    print("RESULT_JSON:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def feed_counts() -> dict:
    """{(arch, cell, feed): the layer's collective bytes a device}, feed
    "auto" being the layer's own choice."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, os.path.dirname(__file__), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_FEEDS)],
                          capture_output=True, text=True, env=env,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT_JSON:")][0]
    return {tuple(k): n for *k, n in json.loads(line[len("RESULT_JSON:"):])}


def _modelled(arch: str, shape: str) -> tuple:
    """``ffn.feed_bytes`` for the layer's expert group on ``pod16x16``
    (16 "data" ranks split the tokens and FSDP's d, 16 "model" ranks the
    experts)."""
    from repro_torch.configs import get_config
    from repro_torch.models.ffn import feed_bytes

    cfg = get_config(arch)
    b, t, grad = FEED_CELLS[shape]
    s = b * t
    cap = min(s, int((s * cfg.top_k / cfg.n_experts)
                     * cfg.capacity_factor) + 1)
    return feed_bytes(cfg.n_experts // 16, cap, cfg.d_model,
                      cfg.d_ff_expert, 2, 16, 16, grad)


@pytest.mark.parametrize("shape", sorted(FEED_CELLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_the_layer_feeds_its_experts_the_cheaper_way(feed_counts, arch,
                                                     shape):
    """Decode's few rows take embed blocks (the group's weights whole
    would move 0.25-0.47 GB a layer), prefill's and training's million
    rows slot blocks (the embed blocks' capacity rows and partial
    products move 3-17 GB more); the modelled difference is the
    counter's within 2%."""
    slot, embed = (feed_counts[arch, shape, f] for f in ("slot", "embed"))
    assert feed_counts[arch, shape, "auto"] == min(slot, embed)
    assert (slot < embed) == (shape != "decode_32k"), (slot, embed)
    m_slot, m_embed = _modelled(arch, shape)
    assert abs((m_slot - m_embed) - (slot - embed)) <= \
        0.02 * abs(slot - embed), (m_slot - m_embed, slot - embed)


if __name__ == "__main__":
    counts = feed_counts.__wrapped__()
    for arch in ARCHS:
        for shape in FEED_CELLS:
            print(arch, shape, *(f"{f}={counts[arch, shape, f]:,}"
                                 for f in ("auto", "slot", "embed")),
                  "modelled slot, embed = %s, %s" % _modelled(arch, shape))

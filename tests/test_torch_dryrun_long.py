"""The port's dry run of the ``long_500k`` cells (one row at 524,288
cache slots) on both meshes, against the JAX package's figures.

A batch of one leaves "pod" idle on ``pod2x16x16``: the JAX package
gives the same figures there as on ``pod16x16``, and so must the port.
Its attention splits the heads, and shares a kv head's replica, over
"model", the dim the JAX package's rules give them
(``launch/sharding.py::logical_rules``); "pod" repeats the work.  Its
decode blocks settle the residual stream where their forwards do, so no
product takes a partial sum: a step moves about one all-reduce of the
(1, d_model) stream a row-split product, and the head's.

Each cell runs in a subprocess of its own (the fake process group
belongs to the process), all of them started together, with a spy on
the step counter that records the q heads of each ``decode_attention``
call.  The JAX figures not measured live are the JAX package's
``run_cell`` on this repo's CPU (jax 0.9.0), ``dot_flops`` counted from
its partitioned HLO as ``test_torch_dryrun._REFERENCE`` counts them,
equal on both meshes.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import _REFERENCE, _ok  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
ARCHS = ("gemma3-1b", "recurrentgemma-9b", "falcon-mamba-7b", "gemma3-12b")

# the JAX package's (dot_flops, collective_bytes_per_device), long_500k,
# the same on pod16x16 and pod2x16x16; gemma3-1b's is also run live
JAX = {
    "gemma3-1b": (158_703_616, 85_206_416),
    "recurrentgemma-9b": (1_073_795_072, 4_540_512),
    "falcon-mamba-7b": (875_560_960, 1_794_048),
    "gemma3-12b": (1_741_684_736, 543_732_096),
}

# the port's (flops, collective bytes) a device, the same on both meshes
PORT = {
    "gemma3-1b": (158_703_616, 777_088),
    "recurrentgemma-9b": (1_175_977_984, 878_688),
    "falcon-mamba-7b": (875_298_816, 700_416),
    "gemma3-12b": (1_741_684_736, 6_430_592),
}

_PORT = '''
import json
from repro_torch.launch import dryrun as D

heads = []
real = D.StepCounter._count


def count(self, func, args, kwargs, out):
    real(self, func, args, kwargs, out)
    if func._overloadpacket.__name__ == "decode_attention":
        heads.append(args[0].shape[1])


D.StepCounter._count = count
r = D.run_cell("{arch}", "long_500k", multi_pod={multi}, save=False)
r["decode_heads"] = heads
print("RESULT_JSON:" + json.dumps(r, default=str))
'''


def _start(code: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _finish(proc) -> dict:
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    line = [ln for ln in stdout.splitlines()
            if ln.startswith("RESULT_JSON:")][0]
    return json.loads(line[len("RESULT_JSON:"):])


@pytest.fixture(scope="module")
def cells():
    """Every (arch, multi_pod) cell, and gemma3-1b's JAX cell on
    ``pod2x16x16`` under ``"jax"``."""
    procs = {(a, mp): _start(_PORT.replace("{arch}", a)
                             .replace("{multi}", str(mp)))
             for a in ARCHS for mp in (False, True)}
    ref = _start(_REFERENCE.replace('"granite-8b", "decode_32k", False',
                                    '"gemma3-1b", "long_500k", True'))
    out = {key: _finish(p) for key, p in procs.items()}
    out["jax"] = _finish(ref)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_the_idle_pod_axis_changes_no_figure(cells, arch):
    """``pod2x16x16`` counts exactly what ``pod16x16`` counts: flops,
    bytes, collectives by op, kernel calls, the live-bytes peak."""
    single, multi = cells[(arch, False)], cells[(arch, True)]
    for r, chips in ((single, 256), (multi, 512)):
        _ok(r)
        assert r["chips"] == chips and r["step_kind"] == "decode"
    for key in ("flops_per_device", "bytes_accessed_per_device",
                "collective_bytes_per_device", "collectives",
                "collective_counts", "collective_largest", "kernel_calls",
                "memory"):
        assert multi[key] == single[key], key
    assert multi["decode_heads"] == single["decode_heads"]


@pytest.mark.parametrize("arch", ARCHS)
def test_figures_against_the_jax_package(cells, arch):
    """The port's flops and collective bytes a device (``PORT``) beside
    the JAX package's (``JAX``): gemma3-1b and gemma3-12b equal its
    dots; falcon-mamba-7b is 262,144 flops under them; recurrentgemma-9b
    is 1.095 of them, since the JAX counter reads each RG-LRU gate's
    windowed loop of (256,) x (256, 256) dots once, where the port's
    rank multiplies its 256 channels by the gate's 4,096 columns.
    Every collective total is below the JAX package's."""
    for mp in (False, True):
        r = cells[(arch, mp)]
        flops, coll = PORT[arch]
        assert (r["flops_per_device"], r["collective_bytes_per_device"]) \
            == (flops, coll)
        assert coll < JAX[arch][1]
    if arch.startswith("gemma3"):
        assert PORT[arch][0] == JAX[arch][0]


def test_gemma3_1b_equals_the_live_jax_cell_on_the_pod_mesh(cells):
    """gemma3-1b on ``pod2x16x16``, against the JAX package's cell run
    here: flops equal its dots (the parent's 394,846,208 attended 2 q
    heads over 32,768 keys a rank where ``pod16x16`` attends 1 over
    8,192), collective bytes below its total."""
    ref = cells["jax"]
    assert ref["status"] == "ok" and ref["chips"] == 512
    assert (ref["dot_flops"], ref["collective_bytes_per_device"]) \
        == JAX["gemma3-1b"]
    r = cells[("gemma3-1b", True)]
    assert r["flops_per_device"] == ref["dot_flops"] == 158_703_616
    assert r["collective_bytes_per_device"] \
        < ref["collective_bytes_per_device"]


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "gemma3-1b"])
def test_decode_attends_one_q_head_a_rank(cells, arch):
    """recurrentgemma-9b's 16 q heads over its one kv head and 16 model
    ranks: one q head a rank in each of the 12 attention layers (the
    parent attended 8 on ``pod2x16x16``, where "pod" took the split);
    gemma3-1b's 4 q heads: 16 ranks share the kv head, 4 a q head, each
    over a quarter of its slots, one head a call."""
    from repro_torch.configs import get_config

    layers = sum(k in ("attn", "local")
                 for k in get_config(arch).layer_kinds())
    for mp in (False, True):
        assert cells[(arch, mp)]["decode_heads"] == [1] * layers


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_recurrent_decode_moves_at_most_the_jax_packages_bytes(cells, arch):
    """A step's collectives: an all-reduce of the (1, 4096) bf16 stream
    after each row-split product (Mamba's ``out_proj``, RG-LRU's
    ``out``, attention's ``wo``, the FFN's ``w2``) and the lookup's, no
    larger all-gather.  falcon-mamba-7b adds each layer's
    all-to-all of its in-projection's halves and ``x_proj``'s (1, 288)
    sum; recurrentgemma-9b each gate's reduce-scatter and the local
    caches' first slots (``roll_slots``).  At most the JAX package's
    totals (the parent: 18,490,368 / 23,518,208 and 8,159,328 /
    11,876,096)."""
    stream = 4096 * 2
    for mp in (False, True):
        r = cells[(arch, mp)]
        assert r["collective_bytes_per_device"] <= JAX[arch][1]
        assert r["collective_largest"]["all-reduce"] == stream
        assert r["collective_largest"].get("all-gather", 0) <= stream

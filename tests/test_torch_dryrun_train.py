"""The port's dry run of the training cells (``repro_torch.launch.dryrun``,
``train_4k``) against the JAX package's figures: granite-8b, gemma3-1b,
falcon-mamba-7b and recurrentgemma-9b on ``pod16x16`` here, on
``pod2x16x16`` in ``test_torch_dryrun_train_multi.py`` and
``test_torch_dryrun_train_ssm.py`` (files of their own, so that
``--dist loadfile`` runs the cells on three workers).  Each cell runs
in a subprocess of its own (the fake process group belongs to the
process), the four of a file started together.

On every mesh the residual stream is split by rows only, whole over
``model``, in the forward and the backward (``models/common.py``:
``copy_to_model`` before column-parallel products, ``reduce_from_model``
after row-parallel ones), so a rank does its rows' share of every
product: on 512 ranks half of what it does on 256.  The head keeps the
logits split by vocab and the loss reads them so: no all-reduce is as
large as a rank's vocab share of f32 logits, and the largest is the
stream's own sum, (rows, T, d_model) bf16.

The JAX figures are ``flops_per_device`` of the JAX package's
``run_cell`` on this repo's CPU, pinned as ``test_torch_dryrun_ssm.py``
pins its own (``test_torch_dryrun_train_multi.py`` reproduces one
live).  They count elementwise work, which the port's counter does not,
so the port's figure is 0.85-1.05 of the JAX one.  Outside attention
it is 0.85-1.05 of it in every cell: the JAX figures with the
attention replaced by its query are pinned beside them
(``repro.kernels.flash_attention.ops.attention`` and
``repro.models.attention.mha_ref`` set to ``lambda q, k, v, *a, **kw:
q``, which also drops the k and v projections), and the port's own
attention (the ``flash_attention`` operator and the recompute's
``bmm``s, each rank's slice) is counted apart by a spy on the step
counter.  gemma3-1b is below the band as a whole: its 4 q heads over
one kv head do not split 16 ways, the port attends zig-zag query
chunks on each rank (a sixteenth of the causal work, 1.9e12 flops at
``pod16x16``) where the JAX package's attention takes 9.9e12 (its
figure less the one without attention).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import _ok  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
T, BATCH = 4096, 256
ARCHS = ("granite-8b", "gemma3-1b", "falcon-mamba-7b", "recurrentgemma-9b")

# the JAX package's flops_per_device, train_4k, (arch, multi_pod)
JAX_FLOPS = {
    ("granite-8b", False): 287_368_257_470_464,
    ("granite-8b", True): 143_694_014_709_760,
    ("gemma3-1b", False): 39_898_037_354_496,
    ("gemma3-1b", True): 19_953_360_896_000,
    ("falcon-mamba-7b", False): 225_655_222_632_448,
    ("falcon-mamba-7b", True): 112_834_088_206_336,
    ("recurrentgemma-9b", False): 308_496_526_999_552,
    ("recurrentgemma-9b", True): 154_258_911_789_056,
}
# the same with the attention replaced by its query (falcon-mamba-7b has
# no attention)
JAX_FLOPS_NO_ATTENTION = {
    ("granite-8b", False): 236_815_523_381_248,
    ("granite-8b", True): 118_415_124_004_864,
    ("gemma3-1b", False): 30_030_822_637_568,
    ("gemma3-1b", True): 15_016_372_666_368,
    ("falcon-mamba-7b", False): 225_655_222_632_448,
    ("falcon-mamba-7b", True): 112_834_088_206_336,
    ("recurrentgemma-9b", False): 294_016_452_132_864,
    ("recurrentgemma-9b", True): 147_016_637_218_816,
}
# the port's figures on pod16x16; pod2x16x16 is held to half of them
PORT_FLOPS = {
    "granite-8b": 284_501_049_606_144,
    "gemma3-1b": 31_444_755_808_256,
    "falcon-mamba-7b": 209_680_303_390_720,
    "recurrentgemma-9b": 302_847_136_628_736,
}
CALLS = {
    "granite-8b": ({"flash_attention": 72}, {}),
    "gemma3-1b": ({"flash_attention": 100}, {}),
    "falcon-mamba-7b": ({}, {"ssm_scan": 128, "ssm_scan_backward": 64}),
    "recurrentgemma-9b": ({"flash_attention": 24},
                          {"rglru_scan": 50, "rglru_scan_backward": 26}),
}

# the port's cell, with a spy on the step counter: the flops of the
# attention's operators (the kernel's and the recompute's products; no
# other block of these configs runs a bmm) and the input shape of every
# all-gather
_PORT = '''
import json
from repro_torch.launch import dryrun as D

gathers, attention = [], [0]
real = D.StepCounter._count


def count(self, func, args, kwargs, out):
    name = func._overloadpacket.__name__
    before = self.flops
    real(self, func, args, kwargs, out)
    if name in ("flash_attention", "bmm"):
        attention[0] += self.flops - before
    if name == "all_gather_into_tensor":
        gathers.append(list(args[0].shape))


D.StepCounter._count = count
r = D.run_cell("{arch}", "train_4k", multi_pod={multi}, save=False)
r["attention_flops"] = attention[0]
r["gather_inputs"] = gathers
print("RESULT_JSON:" + json.dumps(r, default=str))
'''


def _start(code: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _finish(proc) -> dict:
    stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0, stderr[-3000:]
    line = [ln for ln in stdout.splitlines()
            if ln.startswith("RESULT_JSON:")][0]
    return json.loads(line[len("RESULT_JSON:"):])


def start_train_cell(arch: str, multi_pod: bool):
    return _start(_PORT.replace("{arch}", arch)
                  .replace("{multi}", str(multi_pod)))


def train_cells(archs, multi_pod: bool) -> dict:
    """``train_4k`` of ``archs``, each in a process of its own, started
    together."""
    procs = {a: start_train_cell(a, multi_pod) for a in archs}
    return {a: _finish(p) for a, p in procs.items()}


def check_train_cell(r: dict, arch: str, multi_pod: bool) -> None:
    """The checks every training cell meets (module docstring)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    ranks = 512 if multi_pod else 256
    rows = BATCH // (ranks // 16)
    _ok(r)
    assert r["chips"] == ranks and r["step_kind"] == "train"
    assert (r["kernel_calls"], r["operator_calls"]) == CALLS[arch]

    # against the JAX package: as a whole, and outside attention
    key = (arch, multi_pod)
    ratio = r["flops_per_device"] / JAX_FLOPS[key]
    outside = (r["flops_per_device"] - r["attention_flops"]) \
        / JAX_FLOPS_NO_ATTENTION[key]
    assert 0.85 <= outside <= 1.05, outside
    if arch == "gemma3-1b":
        jax_attention = JAX_FLOPS[key] - JAX_FLOPS_NO_ATTENTION[key]
        assert r["attention_flops"] < jax_attention / 4
        assert 0.75 < ratio < 0.85, ratio
    else:
        assert 0.85 <= ratio <= 1.05, ratio

    # collectives: the stream's sum is the largest all-reduce, below a
    # rank's vocab share of f32 logits
    vocab = -(-cfg.vocab_size // 16)
    largest = r["collective_largest"]["all-reduce"]
    assert largest == rows * T * cfg.d_model * 2
    assert largest <= rows * T * vocab * 4
    # no all-gather moves a rank's vocab slice of the table, the logits
    # or their gradients; the table's gradient, summed over the 512
    # ranks' batch dims, is reduce-scattered and gathered in sixteenths
    for shape in r["gather_inputs"]:
        if vocab in shape:
            n = 1
            for s in shape:
                n *= s
            assert n <= vocab * cfg.d_model // 16, shape


@pytest.fixture(scope="module")
def cells():
    return train_cells(ARCHS, False)


@pytest.mark.parametrize("arch", ARCHS)
def test_single_pod_train_cell(cells, arch):
    r = cells[arch]
    check_train_cell(r, arch, False)
    assert r["flops_per_device"] == PORT_FLOPS[arch]

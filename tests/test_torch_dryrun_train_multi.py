"""The port's dry run of granite-8b and gemma3-1b ``train_4k`` on
``pod2x16x16`` (512 ranks), held to the checks of
``test_torch_dryrun_train.py`` and to half of each one's ``pod16x16``
figure (the 256 rows of 4,096 tokens split 32 ways instead of 16); and
one of the JAX figures pinned there, reproduced live: falcon-mamba-7b's
on this mesh, whose JAX cell compiles in about 10 s.  The port's cells
and the JAX one each run in a process of their own, started
together."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun_train import (JAX_FLOPS, PORT_FLOPS,  # noqa: E402
                                     _finish, _start, check_train_cell,
                                     start_train_cell)

ARCHS = ("granite-8b", "gemma3-1b")

_JAX_CELL = '''
import json
from repro.launch.dryrun import run_cell

r = run_cell("falcon-mamba-7b", "train_4k", True, save=False)
print("RESULT_JSON:" + json.dumps(
    {k: r.get(k) for k in ("status", "chips", "flops_per_device")}))
'''


@pytest.fixture(scope="module")
def cells():
    reference = _start(_JAX_CELL)
    procs = {a: start_train_cell(a, True) for a in ARCHS}
    out = {a: _finish(p) for a, p in procs.items()}
    out["reference"] = _finish(reference)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_multi_pod_train_cell(cells, arch):
    r = cells[arch]
    check_train_cell(r, arch, True)
    assert 0.48 <= r["flops_per_device"] / PORT_FLOPS[arch] <= 0.52


def test_the_pinned_jax_figure_reproduces(cells):
    ref = cells["reference"]
    assert ref["status"] == "ok" and ref["chips"] == 512
    assert ref["flops_per_device"] == JAX_FLOPS[("falcon-mamba-7b", True)]

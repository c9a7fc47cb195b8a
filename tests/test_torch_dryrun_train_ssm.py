"""The port's dry run of falcon-mamba-7b and recurrentgemma-9b
``train_4k`` on ``pod2x16x16`` (512 ranks), held to the checks of
``test_torch_dryrun_train.py`` and to half of each one's ``pod16x16``
figure: the Mamba and RG-LRU blocks' products, their time scans (each
rank's rows and channels) and, in recurrentgemma-9b, the local
attention all split by rows over ``pod`` and ``data``.  Each cell runs
in a process of its own, the two started together."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun_train import (  # noqa: E402
    PORT_FLOPS, check_train_cell, train_cells)

ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b")


@pytest.fixture(scope="module")
def cells():
    return train_cells(ARCHS, True)


@pytest.mark.parametrize("arch", ARCHS)
def test_multi_pod_train_cell(cells, arch):
    r = cells[arch]
    check_train_cell(r, arch, True)
    assert 0.48 <= r["flops_per_device"] / PORT_FLOPS[arch] <= 0.52

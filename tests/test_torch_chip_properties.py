"""``chip_smoke.py``'s phase P rehearsed on the CPU: the five identities
run on ``cpu`` tensors over the CPU suites' own draws
(``tests/torch_properties.py``), so the phase the card runs cannot rot
unseen.  On the CPU the wrappers run their plain versions: nothing is
launched and the host tier's copy is the same tensor."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke as C  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("identity", [C.p_fused, C.p_budgets, C.p_mqo,
                                      C.p_faults, C.p_pruned],
                         ids=["P1", "P2", "P3", "P4", "P5"])
def test_identity_holds_on_the_cpu(identity):
    out = identity(torch.device("cpu"))
    assert out and all(v > 0 for v in out.values()), out


def test_phase_launches_nothing_on_the_cpu(capsys):
    launches = C.properties_phase(torch.device("cpu"), "cpu")
    assert set(launches.values()) == {0}
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("P")]
    assert [ln[:2] for ln in lines] == ["P1", "P2", "P3", "P4", "P5"]
    assert all("; launches none; " in ln for ln in lines)

"""One train step of the port (loss, gradients, AdamW) against
the JAX package's ``make_train_step``: the Mamba, RG-LRU, MoE and MLA
families.  Harness, cases and tolerances: ``torch_train_parity.py``."""
import pytest

from torch_parity import one_torch_thread  # noqa: F401
from torch_train_parity import FAMILY_CASES, check_train_step

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("arch,impl", FAMILY_CASES)
def test_train_step_matches_the_reference(arch, impl):
    check_train_step(arch, impl)

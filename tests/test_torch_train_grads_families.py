"""The port's loss and gradients against
``jax.value_and_grad`` of the JAX package's ``loss_fn``: the Mamba,
RG-LRU, MoE and MLA families.  Harness, cases and tolerances: ``torch_train_parity.py``."""
import pytest

from torch_parity import one_torch_thread  # noqa: F401
from torch_train_parity import FAMILY_CASES, check_loss_and_grads

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("arch,impl", FAMILY_CASES)
def test_loss_and_grads_match_the_reference(arch, impl):
    check_loss_and_grads(arch, impl)

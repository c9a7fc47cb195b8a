"""examples/torch_analytics_server.py against the JAX package's
examples/analytics_server.py on the CPU, at tests/test_examples.py's
reduced arguments: the same strings and every printed line that
carries no time or rate equal (the dashboard's reuse per pass, the
canonicalization window, fault injection and the doomed handle, the
batched windows, the drill-downs, the metrics report)."""

import pytest
import torch

from torch_example_parity import disagreement, run_example

JAX_SCRIPT, PORT_SCRIPT = "analytics_server.py", "torch_analytics_server.py"
ARGS = ("--window", "6", "--scale-rows", "20000")
# the strings tests/test_examples.py asserts of the JAX package's example
STRINGS = ("aggregate ratio", "warm speedup over cold")


@pytest.fixture(scope="module")
def outputs():
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        jax = pool.submit(run_example, JAX_SCRIPT, *ARGS)
        port = pool.submit(run_example, PORT_SCRIPT, *ARGS, "--device",
                           "cpu")
        jax, port = jax.result(), port.result()
    assert jax.returncode == 0, jax.stderr[-2000:]
    assert port.returncode == 0, port.stderr[-2000:]
    return jax.stdout, port.stdout


@pytest.mark.parametrize("string", STRINGS)
def test_port_prints_the_reference_strings(outputs, string):
    assert string in outputs[1]


def test_lines_agree_with_the_jax_example(outputs):
    jax, port = outputs
    assert len(port.splitlines()) == len(jax.splitlines())
    assert disagreement(jax, port) is None, disagreement(jax, port)


def test_fault_and_reuse_lines_are_compared(outputs):
    """The decision lines (reuse counts, the faulted window, the doomed
    handle's attempts, the drill-downs) carry no time and are compared
    as they are."""
    import chip_smoke

    port = outputs[1].splitlines()
    for key in ("queries with resident-CE reuse", "faulted window:",
                "doomed handle:", "drill-down 2:", "batched window 1:"):
        line = next(x for x in port if x.startswith(key))
        assert chip_smoke.timeless(line) == line, line


def test_default_device_is_cuda():
    out = run_example(PORT_SCRIPT, *ARGS, "--help")
    assert "--device" in out.stdout and "default cuda" in out.stdout
    if not torch.cuda.is_available():
        out = run_example(PORT_SCRIPT, *ARGS)
        assert out.returncode != 0
        assert "--device cpu" in out.stderr

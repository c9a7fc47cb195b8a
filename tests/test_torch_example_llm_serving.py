"""examples/torch_llm_serving_mqo.py against the JAX package's
examples/llm_serving_mqo.py on the CPU (granite-8b-smoke, 6 requests):
the same strings and the decision lines (shared prefixes, admitted,
pool KiB, prefill tokens) equal.  Tokens are compared only within one
package (``generations identical: True``): each package draws its own
initial weights."""

import pytest
import torch

from torch_example_parity import disagreement, run_example

JAX_SCRIPT, PORT_SCRIPT = "llm_serving_mqo.py", "torch_llm_serving_mqo.py"
ARGS = ("--requests", "6")
# the strings tests/test_examples.py asserts of the JAX package's example
STRINGS = ("generations identical: True",)


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


@pytest.mark.parametrize("key", ["shared prefixes found:",
                                 "prefill tokens:"])
def test_decision_lines_equal(outputs, key):
    jax, port = outputs
    pick = [next(x for x in out.splitlines() if x.startswith(key))
            for out in (jax, port)]
    assert pick[0] == pick[1]


def test_default_device_is_cuda():
    out = run_example(PORT_SCRIPT, *ARGS, "--help")
    assert "--device" in out.stdout and "default cuda" in out.stdout
    if not torch.cuda.is_available():
        out = run_example(PORT_SCRIPT, *ARGS)
        assert out.returncode != 0
        assert "--device cpu" in out.stderr

"""Harness of the example parity tests: runs an example of the JAX
package and its port (``examples/torch_*.py``, on the CPU) as
subprocesses with the same arguments, and compares their printed lines
the way ``chip_smoke.py`` phase E1 compares the card's with the CPU's
(``chip_smoke.first_disagreement``: lines equal once the clock-dependent
numbers are masked, decimals within its F32_RTOL)."""
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# The degradation ladder's middle rung is the fused XLA function in the
# JAX package and the fused torch function in the port.
RUNG_NAMES = (("fused-xla", "fused-torch"),)


def run_example(script, *args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(ROOT, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    # one intra-op thread, as the in-process port tests run torch: the
    # parallel test workers already fill the cores
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), *args],
        capture_output=True, text=True, env=env, timeout=timeout)
    return out


def run_ok(script, *args):
    out = run_example(script, *args)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def disagreement(jax_out: str, port_out: str):
    """The first line pair of the two outputs that does not agree (the
    JAX package's rung names read as the port's), or None."""
    for ref, port in RUNG_NAMES:
        jax_out = jax_out.replace(ref, port)
    return chip_smoke.first_disagreement(jax_out, port_out)

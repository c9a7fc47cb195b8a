"""The port's example scripts run end to end on the CPU (subprocess
smoke, reduced sizes, as ``tests/test_examples.py`` runs the JAX
package's)."""
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _run(script, *args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(ROOT, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    # one intra-op thread, as the in-process port tests run torch: the
    # parallel test workers already fill the cores
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), *args],
        capture_output=True, text=True, env=env, timeout=timeout)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_train_lm(tmp_path):
    out = _run("torch_train_lm.py", "--steps", "40", "--width", "128",
               "--layers", "2", "--seq-len", "128", "--batch", "4",
               "--ckpt-dir", str(tmp_path), "--device", "cpu")
    assert "improved" in out

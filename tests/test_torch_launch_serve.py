"""The port's serving launcher (``python -m repro_torch.launch.serve``)
against the JAX package's on the CPU: the same flags, the same
``-smoke`` config choice and the same decision lines (prefix SEs,
admitted, prefill tokens, pool KiB).  The printed tokens are not
compared: each package draws its own initial weights."""
import sys

import pytest
import torch

from repro.launch import serve as jax_serve
from repro_torch.launch import serve as port_serve

CASES = {
    "granite-8b": ("--arch", "granite-8b"),
    "granite-8b-no-mqo": ("--arch", "granite-8b", "--no-mqo"),
    "smoke-name-small-pool": ("--arch", "granite-8b-smoke", "--requests",
                              "5", "--pool-budget-kib", "64",
                              "--block-size", "16"),
    "falcon-mamba-7b": ("--arch", "falcon-mamba-7b", "--requests", "4"),
}


def _lines(run, capsys):
    run()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("args", CASES.values(), ids=CASES.keys())
def test_decision_lines_equal_the_jax_launcher(args, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    want = _lines(jax_serve.main, capsys)
    got = _lines(lambda: port_serve.main([*args, "--device", "cpu"]),
                 capsys)
    assert got[:2] == want[:2]
    assert got[0].startswith("served ")
    # one token line a request, up to four, eight tokens each
    assert len(got) == len(want)
    for line in got[2:]:
        assert len(line.split(": ", 1)[1].strip("[]").split(",")) == 8


def test_default_device_is_cuda():
    from repro_torch.device import cli_device

    if torch.cuda.is_available():
        assert cli_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_serve.main(["--arch", "granite-8b"])

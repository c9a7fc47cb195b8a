"""Shared helpers of the PyTorch port's bench scripts
(``benchmarks/torch_bench_*.py``): the ``--device`` flag, the device
record every result carries, and the speed gate as the exit status."""
from __future__ import annotations

import argparse
import subprocess
from typing import Callable, Dict, List, Optional

from common import save_result


def parse_args(argv=None, description: str = "",
               add: Optional[Callable] = None):
    """The bench's command line: ``--device`` (default cuda), resolved
    to a ``torch.device`` (without a GPU the default raises), and the
    flags ``add(parser)`` declares; returns (device, parsed args)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    if add is not None:
        add(ap)
    args = ap.parse_args(argv)
    from repro_torch.device import cli_device

    return cli_device(args.device), args


def parse_device(argv=None, description: str = ""):
    """:func:`parse_args` for a bench whose only flag is ``--device``."""
    return parse_args(argv, description)[0]


def device_record(device) -> Dict:
    """What ran the bench: the torch device, the card's name and power
    limit as ``nvidia-smi`` reports them (``None`` on the CPU), and the
    torch version."""
    import torch

    dev = torch.device(device)
    rec = {"device": str(dev), "device_name": "cpu", "power_limit": None,
           "torch": torch.__version__}
    if dev.type == "cuda":
        rec["device_name"] = torch.cuda.get_device_name(dev)
        rec["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    return rec


def save(name: str, out: Dict, device) -> Dict:
    """Write ``out`` with the device record to
    ``reports/bench/torch_<name>.json``; returns what was written."""
    payload = {**out, **device_record(device)}
    save_result(f"torch_{name}", payload)
    return payload


def finish(lines: List[str], failures: List[str]) -> int:
    """Print the CSV lines and the speed gate's failures; the exit
    status is 1 when the gate failed."""
    print("\n".join(lines))
    for f in failures:
        print(f"# gate failed: {f}")
    return 1 if failures else 0

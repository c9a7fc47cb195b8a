"""The tracing-overhead gate on the PyTorch port (the counterpart of
``benchmarks/bench_telemetry.py``): a thin runner around
``torch_bench_service.run_tracing_overhead``, on the GPU unless
``--device`` says otherwise.  Warm-window throughput on the recurring
dashboard with span tracing on must stay ``>= 0.95x`` the throughput
with it off (the metrics registry and calibration log are on in both).

    PYTHONPATH=src python benchmarks/torch_bench_telemetry.py \\
        [--device cpu]
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

sys.path.insert(0, os.path.dirname(__file__))

from torch_bench_service import (  # noqa: E402
    run_tracing_overhead, tracing_gate, tracing_line)
from torch_common import finish, parse_device  # noqa: E402


def run(device="cuda", **kw) -> Dict:
    return run_tracing_overhead(device, **kw)


def gate(out: Dict) -> List[str]:
    return tracing_gate(out)


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    out = run(device)
    return finish([tracing_line(out)], gate(out))


if __name__ == "__main__":
    sys.exit(main())

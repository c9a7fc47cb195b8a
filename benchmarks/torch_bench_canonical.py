"""Mixed-syntax recurring stream on the PyTorch port (the counterpart
of ``benchmarks/bench_canonical.py``): the canonical plan IR recovers
cross-window CE sharing when every dashboard pass spells the same
queries differently, on the GPU unless ``--device`` says otherwise.
The lane lives in ``torch_bench_service.py`` (``run_mixed``), as the
JAX bench's lives in ``bench_service.py``; this is its runner.

Speed gate (the exit status, the reference's acceptance):
``mixed_warm_speedup >= 1.3`` and ``canonical_hit_rate > 0``.

    PYTHONPATH=src python benchmarks/torch_bench_canonical.py \\
        [--device cpu]
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

sys.path.insert(0, os.path.dirname(__file__))

from torch_bench_service import mixed_gate, mixed_line, run_mixed  # noqa: E402
from torch_common import finish, parse_device  # noqa: E402


def run(device="cuda", **kw) -> Dict:
    return run_mixed(device, **kw)


def gate(out: Dict) -> List[str]:
    return mixed_gate(out)


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    out = run(device)
    return finish([mixed_line(out)], gate(out))


if __name__ == "__main__":
    sys.exit(main())

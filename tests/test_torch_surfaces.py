"""How ``chip_smoke.py`` phase E1 compares an example's output on the
card with its output on the CPU (and the example tests compare the JAX
package's with the port's): what depends on the clock is masked, every
other printed value must be equal, decimals within F32_RTOL."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke as C  # noqa: E402


@pytest.mark.parametrize("line,masked", [
    ("q1: rows=  7857 identical=True runtime 0.725s -> 0.029s",
     "q1: rows=  7857 identical=True runtime <t> -> <t>"),
    ("aggregate: 1.238s -> 0.070s (0.06x)",
     "aggregate: <t> -> <t> (<t>)"),
    ("latency p50/p90/p99 = 53.2/3515.5/3904.0 ms over 2 template families",
     "latency p50/p90/p99 = <t> over 2 template families"),
    ("aggregate ratio (warm windowed / no-MQO): 0.95",
     "aggregate ratio (warm windowed / no-MQO): <t>"),
    ("async adaptive serving: 24 queries from 6 concurrent clients in "
     "1.85s (13 q/s), window sizes [8, 8, 16]",
     "async adaptive serving: 24 queries from 6 concurrent clients in "
     "<t> (<t>), window sizes <t>"),
    ("  tenant team0: submitted=12 bytes=983040B admission={'inflight': 0}",
     "  tenant team0: submitted=12 bytes=<t> admission={'inflight': 0}"),
])
def test_clock_dependent_values_are_masked(line, masked):
    assert C.timeless(line) == masked


@pytest.mark.parametrize("line", [
    "SEs found: 4   CEs built: 4   selected: 3   cache weight: 910 KiB "
    "(budget 57 MiB)",
    "prefill tokens: 345 vs baseline 639 (ratio 0.54)",
    "pid pool: run 1 recorded 1 bitset(s); run 2 hit 1 and pruned 2/8 "
    "partitions (identical rows: True)",
    "shared prefixes found: 9, admitted: 3 (pool 216 / 4096 KiB)",
    "partitioned scan: salary>80000 touches 1/8 partitions [7]",
])
def test_decision_lines_are_not_masked(line):
    assert C.timeless(line) == line


@pytest.mark.parametrize("a,b,agree", [
    ("rows=7857 identical=True", "rows=7857 identical=True", True),
    ("rows=7857 identical=True", "rows=7858 identical=True", False),
    ("identical=True", "identical=False", False),
    ("sum 12345.678", "sum 12345.679", True),        # within 1e-5
    ("sum 12345.678", "sum 12346.678", False),
    ("ratio 0.54", "ratio 0.55", False),
    ("runtime 0.1s", "runtime 9.9s", True),
])
def test_lines_agree(a, b, agree):
    assert C.lines_agree(a, b) is agree


def test_first_disagreement():
    a = "x 1\ny 2\nz 0.5s"
    assert C.first_disagreement(a, "x 1\ny 2\nz 7.5s") is None
    assert C.first_disagreement(a, "x 1\ny 3\nz 0.5s") == (1, "y 2", "y 3")
    assert C.first_disagreement(a, "x 1\ny 2") == (2, "z 0.5s", "")

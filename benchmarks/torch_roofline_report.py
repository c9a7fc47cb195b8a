"""Roofline report of the PyTorch port's dry run: renders
``reports/dryrun_torch/*.json`` (written by ``python -m
repro_torch.launch.dryrun``) into the roofline markdown table and one
CSV line per cell, as ``roofline_report.py`` does for the JAX package's
``reports/dryrun/``.  The terms are an NVIDIA H100's (the dry run names
the part in each report's ``roofline.device``).

    PYTHONPATH=src python benchmarks/torch_roofline_report.py
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

from common import csv_line

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "reports",
                          "dryrun_torch")
MESHES = ("pod16x16", "pod2x16x16")


def load_cells(mesh: str = "pod16x16", directory: str = DRYRUN_DIR
               ) -> List[Dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            c = json.load(f)
        if c.get("mesh") == mesh:
            cells.append(c)
    return cells


def render_table(mesh: str = "pod16x16", directory: str = DRYRUN_DIR
                 ) -> str:
    rows = [
        "| arch | shape | status | compute s | memory s | collective s |"
        " dominant | useful | MFU | card |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in load_cells(mesh, directory):
        if c["status"] == "skipped":
            rows.append(f"| {c['arch']} | {c['shape']} | skipped "
                        f"({c['reason'][:40]}…) | | | | | | | |")
            continue
        if c["status"] != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | ERROR | | | | |"
                        f" | | |")
            continue
        r = c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | ok | {r['compute_s']:.4f} |"
            f" {r['memory_s']:.4f} | {r['collective_s']:.4f} |"
            f" {r['dominant']} | {r['useful_flops_ratio']:.2f} |"
            f" {r['roofline_fraction_mfu']:.3f} | {r['device']} |")
    return "\n".join(rows)


def main(directory: str = DRYRUN_DIR) -> List[str]:
    lines = []
    for mesh in MESHES:
        cells = load_cells(mesh, directory)
        ok = [c for c in cells if c["status"] == "ok"]
        skipped = [c for c in cells if c["status"] == "skipped"]
        err = [c for c in cells if c["status"] == "error"]
        lines.append(csv_line(
            f"dryrun_torch[{mesh}]", 0.0,
            f"ok={len(ok)};skipped={len(skipped)};errors={len(err)}"))
        for c in ok:
            r = c["roofline"]
            lines.append(csv_line(
                f"roofline[{c['arch']},{c['shape']},{mesh}]",
                r["bound_s"],
                f"dominant={r['dominant']};mfu="
                f"{r['roofline_fraction_mfu']:.3f};"
                f"useful={r['useful_flops_ratio']:.2f}"))
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
    print()
    print(render_table())

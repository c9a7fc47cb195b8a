"""Serving-layer prefix-cache MQO on the PyTorch port (the counterpart
of ``benchmarks/bench_serving_prefix.py``), on the GPU unless
``--device`` says otherwise.

A shared-prefix request workload (3 few-shot templates of 128 tokens,
4 requests each with its own tail, 4 new tokens) served by
granite-8b-smoke with MQO off and on: the prefill-token ratio, wall
times, the selected prefixes and the pool's bytes.  Then the per-arch
knapsack weights (the bytes to cache a 4K- and a 32K-token prefix) that
drive admission across the architectures.  Full-width granite-8b
serving is ``chip_smoke.py``'s S2; this bench keeps the JAX bench's
size.  On the card every decode step launches ``decode_attention``.

Correctness (hard failure): the tokens generated with MQO equal those
without.  No speed gate, as in the JAX bench.

    PYTHONPATH=src python benchmarks/torch_bench_serving_prefix.py \\
        [--device cpu]
"""
from __future__ import annotations

import os
import sys
from dataclasses import replace
from typing import Dict, List

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))

from common import csv_line  # noqa: E402
from torch_common import finish, parse_device, save  # noqa: E402

ARCH = "granite-8b"
N_TEMPLATES = 3
PER_TEMPLATE = 4
SHARED_LEN = 128
TAIL = 16
NEW_TOKENS = 4
POOL_BUDGET = 1 << 22
BLOCK_SIZE = 32
MAX_LEN = 256
WEIGHT_ARCHS = ("granite-8b", "deepseek-v2-236b", "gemma3-12b",
                "falcon-mamba-7b", "recurrentgemma-9b")


def _workload(cfg, seed: int = 0) -> List:
    from repro_torch.serving.request import GenerationRequest

    rng = np.random.default_rng(seed)
    reqs, rid = [], 0
    for _ in range(N_TEMPLATES):
        shared = rng.integers(0, cfg.vocab_size, SHARED_LEN)
        for i in range(PER_TEMPLATE):
            p = np.concatenate(
                [shared, rng.integers(0, cfg.vocab_size, TAIL + i)])
            reqs.append(GenerationRequest(rid, p.astype(np.int32),
                                          NEW_TOKENS))
            rid += 1
    return reqs


def prefix_weights(archs=WEIGHT_ARCHS) -> Dict[str, Dict[str, int]]:
    """The serving cost model's state bytes of a 4K / 32K prefix per
    arch (the knapsack weights)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.costs import ServingCostModel

    out = {}
    for a in archs:
        cm = ServingCostModel(get_config(a))
        out[a] = {"prefix_4k_bytes": cm.state_bytes(4096),
                  "prefix_32k_bytes": cm.state_bytes(32768)}
    return out


def run(device="cuda", arch: str = ARCH) -> Dict:
    """MQO off vs on and the weights; writes
    ``reports/bench/torch_serving_prefix.json``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine

    cfg = replace(get_config(arch + "-smoke"), n_prefix_tokens=0)
    params = init_params(cfg, 0, device=device)
    eng = ServingEngine(cfg, params, pool_budget_bytes=POOL_BUDGET,
                        block_size=BLOCK_SIZE, max_len=MAX_LEN)
    base_out, base_rep = eng.run_batch(_workload(cfg), mqo=False)
    mqo_out, rep = eng.run_batch(_workload(cfg), mqo=True)
    for i, (a, b) in enumerate(zip(base_out, mqo_out)):
        assert np.array_equal(a, b), \
            f"request {i}: tokens with MQO differ from tokens without"

    out = {
        "arch": arch,
        "identical_generations": True,
        "tokens_prefilled_mqo": rep.tokens_prefilled,
        "tokens_prefilled_base": rep.tokens_prefilled_baseline,
        "prefill_token_ratio": rep.prefill_token_ratio,
        "wall_mqo_s": rep.wall_seconds,
        "wall_base_s": base_rep.wall_seconds,
        "n_selected": rep.n_selected,
        "pool_used": rep.pool_used,
        "per_arch_prefix_weights": prefix_weights(),
    }
    save("serving_prefix", out, device)
    return out


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    out = run(device)
    w = out["per_arch_prefix_weights"]
    gqa = w["granite-8b"]["prefix_4k_bytes"]
    mla = w["deepseek-v2-236b"]["prefix_4k_bytes"]
    ssm = w["falcon-mamba-7b"]["prefix_4k_bytes"]
    lines = [
        csv_line("serving_prefix[granite-smoke]", out["wall_mqo_s"],
                 f"prefill_ratio={out['prefill_token_ratio']:.2f};"
                 f"wall_ratio={out['wall_mqo_s'] / out['wall_base_s']:.2f};"
                 f"selected={out['n_selected']}"),
        csv_line("prefix_weights[4k]", 0.0,
                 f"gqa={gqa};mla={mla};ssm={ssm};"
                 f"mla_vs_gqa={gqa / max(mla, 1):.1f}x;"
                 f"ssm_vs_gqa={gqa / max(ssm, 1):.1f}x"),
    ]
    return finish(lines, [])


if __name__ == "__main__":
    sys.exit(main())

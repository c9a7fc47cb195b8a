"""LLM-serving scenario on the PyTorch port: prefix-cache MQO over a
few-shot workload, on the GPU unless ``--device`` says otherwise (the
port's counterpart of ``examples/llm_serving_mqo.py``).

Requests sharing few-shot prompt templates are batched; the engine
fingerprints token-block chains, admits shared prefixes into the HBM
pool via the multiple-choice knapsack, and serves every request from
the longest admitted prefix.  Generations are bit-identical to the
unoptimized path.

    PYTHONPATH=src python examples/torch_llm_serving_mqo.py \
        [--arch granite-8b] [--device cpu]
"""
import argparse
import os
import sys
from dataclasses import replace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--budget-kib", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args()

    from repro_torch.configs import get_config
    from repro_torch.device import cli_device
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import GenerationRequest

    cfg = replace(get_config(args.arch + "-smoke"), n_prefix_tokens=0)
    params = init_params(cfg, 0, device=cli_device(args.device))
    eng = ServingEngine(cfg, params,
                        pool_budget_bytes=args.budget_kib << 10,
                        block_size=32, max_len=256)

    rng = np.random.default_rng(0)
    templates = [rng.integers(0, cfg.vocab_size, 96) for _ in range(3)]

    def workload():
        reqs = []
        for i in range(args.requests):
            t = templates[i % len(templates)]
            p = np.concatenate(
                [t, rng.integers(0, cfg.vocab_size, 8 + i)])
            reqs.append(GenerationRequest(i, p.astype(np.int32), 8))
        return reqs

    base, base_rep = eng.run_batch(workload(), mqo=False)
    rng = np.random.default_rng(0)  # same workload again
    templates = [rng.integers(0, cfg.vocab_size, 96) for _ in range(3)]
    opt, rep = eng.run_batch(workload(), mqo=True)

    same = all((a == b).all() for a, b in zip(base, opt))
    print(f"arch={args.arch}-smoke  requests={rep.n_requests}")
    print(f"generations identical: {same}")
    print(f"shared prefixes found: {rep.n_ses}, admitted: "
          f"{rep.n_selected} (pool {rep.pool_used >> 10} / "
          f"{rep.pool_budget >> 10} KiB)")
    print(f"prefill tokens: {rep.tokens_prefilled} vs baseline "
          f"{rep.tokens_prefilled_baseline} "
          f"(ratio {rep.prefill_token_ratio:.2f})")
    print(f"wall: {rep.wall_seconds:.2f}s vs {base_rep.wall_seconds:.2f}s")


if __name__ == "__main__":
    main()

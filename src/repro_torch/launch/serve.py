"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Brings up the prefix-MQO serving engine on a reduced config and runs a
shared-prefix demo workload (see examples/torch_llm_serving_mqo.py for
the scripted version), on ``cuda`` unless ``--device`` names another
device.
"""
from __future__ import annotations

import argparse
from dataclasses import replace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--pool-budget-kib", type=int, default=4096)
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--no-mqo", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..configs import get_config
    from ..device import cli_device
    from ..models.model import init_params
    from ..serving.engine import ServingEngine
    from ..serving.request import GenerationRequest

    device = cli_device(args.device)
    name = args.arch if args.arch.endswith("-smoke") \
        else args.arch + "-smoke"
    cfg = replace(get_config(name), n_prefix_tokens=0)
    params = init_params(cfg, 0, device=device)
    eng = ServingEngine(cfg, params,
                        pool_budget_bytes=args.pool_budget_kib << 10,
                        block_size=args.block_size, max_len=256)

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 96)
    reqs = []
    for i in range(args.requests):
        p = np.concatenate(
            [shared, rng.integers(0, cfg.vocab_size, 8 + i)])
        reqs.append(GenerationRequest(i, p.astype(np.int32), 8))

    outs, rep = eng.run_batch(reqs, mqo=not args.no_mqo)
    print(f"served {rep.n_requests} requests; prefix SEs={rep.n_ses} "
          f"admitted={rep.n_selected}")
    print(f"prefill tokens {rep.tokens_prefilled} / baseline "
          f"{rep.tokens_prefilled_baseline} "
          f"(ratio {rep.prefill_token_ratio:.2f}); "
          f"pool {rep.pool_used >> 10} KiB")
    for i, o in enumerate(outs[:4]):
        print(f"req {i}: {o.tolist()}")


if __name__ == "__main__":
    main()

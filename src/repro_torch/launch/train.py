"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Runs the fault-tolerant trainer on a (reduced or full) config, on
``cuda`` unless ``--device`` names another device.  ``--grad-compress``
is parsed and, as in the JAX package's launcher, not read: the
compressed step is a multi-device path.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="arch id (append -smoke for the reduced config)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--peak-lr", type=float, default=1e-3)
    ap.add_argument("--grad-compress", action="store_true",
                    help="bf16 gradient all-reduce with error feedback")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..data.pipeline import DataConfig
    from ..train.optimizer import OptConfig
    from ..train.trainer import TrainerConfig, train

    cfg = get_config(args.arch)
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch,
        n_prefix_tokens=cfg.n_prefix_tokens, d_model=cfg.d_model)
    opt_cfg = OptConfig(peak_lr=args.peak_lr,
                        decay_steps=max(args.steps, 10))
    tcfg = TrainerConfig(total_steps=args.steps,
                         ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir)
    result = train(cfg, data_cfg, opt_cfg, tcfg, device=args.device)
    print(f"finished at step {result.final_step}"
          + (f" (resumed from {result.resumed_from})"
             if result.resumed_from else ""))
    for m in result.metrics_log[-5:]:
        print(f"step {m['step']:5d} loss {m['loss']:.4f} "
              f"lr {m['lr']:.2e}")


if __name__ == "__main__":
    main()

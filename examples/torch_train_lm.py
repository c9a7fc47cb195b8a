"""End-to-end training driver on the PyTorch port: train a small LM for
a few hundred steps with checkpoint/restart, on the GPU unless
``--device`` says otherwise (the port's counterpart of
``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py \
        [--arch granite-8b] [--steps 300] [--width 512] [--device cpu]
"""
import argparse
import os
import sys
import tempfile
from dataclasses import replace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import TrainerConfig, train

    base = get_config(args.arch + "-smoke")
    cfg = replace(
        base, name=f"{args.arch}-train-demo",
        d_model=args.width, n_heads=max(4, args.width // 64),
        n_kv_heads=max(2, args.width // 128), head_dim=64,
        d_ff=args.width * 4, vocab_size=4096,
        n_layers=args.layers, n_prefix_tokens=0, dtype="float32")
    total, active = cfg.param_count()
    print(f"training {cfg.name}: {total / 1e6:.1f}M params "
          f"({active / 1e6:.1f}M active), {args.steps} steps on "
          f"{args.device}")

    data_cfg = DataConfig(vocab_size=cfg.vocab_size,
                          seq_len=args.seq_len,
                          global_batch=args.batch, seed=0)
    opt_cfg = OptConfig(peak_lr=3e-3, warmup_steps=20,
                        decay_steps=args.steps)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=100,
                         ckpt_dir=args.ckpt_dir, log_every=20)
    result = train(cfg, data_cfg, opt_cfg, tcfg, device=args.device)
    if result.resumed_from is not None:
        print(f"(resumed from checkpoint step {result.resumed_from})")
    for m in result.metrics_log:
        print(f"step {m['step']:4d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  |g| {m['grad_norm']:.3f}  "
              f"{m['step_seconds'] * 1e3:.0f} ms/step")
    first = result.metrics_log[0]["loss"]
    last = result.metrics_log[-1]["loss"]
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'no improvement'})")


if __name__ == "__main__":
    main()

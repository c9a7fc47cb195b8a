"""Training loop with fault tolerance.

The JAX package's trainer (``repro/train/trainer.py``) on torch:
drive the prefetching pipeline, run the train step (which updates the
masters and the optimizer state in place, where the JAX package donates
them), checkpoint asynchronously every ``ckpt_every`` steps,
restore-and-resume on start, survive injected preemptions (the
failure-simulation hook the tests use), and log step metrics.  It runs
on ``cuda`` unless the caller passes ``device=``.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ckpt.checkpoint import CheckpointManager
from ..data.pipeline import DataConfig, Pipeline
from ..device import DeviceLike, resolve_device
from ..models.config import ArchConfig
from ..models.model import init_params
from .optimizer import OptConfig
from .train_step import init_train_state, make_train_step


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_ckpts: int = 3
    log_every: int = 10
    seed: int = 0
    # failure injection for tests: raise after N steps (None = never)
    fail_after_step: Optional[int] = None


class PreemptionError(RuntimeError):
    pass


@dataclass
class TrainResult:
    final_step: int
    metrics_log: List[Dict[str, float]] = field(default_factory=list)
    resumed_from: Optional[int] = None
    params: Any = None
    opt_state: Any = None


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``device``; token and label ids as int64, the
    index type torch's gather and embedding lookups take."""
    return {k: torch.from_numpy(v).to(
        device=device, dtype=torch.int64 if v.dtype.kind in "iu" else None)
        for k, v in batch.items()}


def train(cfg: ArchConfig, data_cfg: DataConfig, opt_cfg: OptConfig,
          tcfg: TrainerConfig, params=None,
          device: DeviceLike = None) -> TrainResult:
    """Train ``cfg`` for ``tcfg.total_steps`` steps, resuming from the
    latest checkpoint in ``tcfg.ckpt_dir``.  ``params``: f32 masters
    (``init_params(..., masters=True)``), drawn from ``tcfg.seed`` when
    None, and updated in place."""
    dev = resolve_device(device)
    ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)

    if params is None:
        params = init_params(cfg, tcfg.seed, dev, masters=True)
    opt_state = init_train_state(cfg, params)

    resumed_from = None
    latest = ckpt.latest_step()
    if latest is not None:
        _, state = ckpt.restore({"params": params, "opt": opt_state},
                                latest)
        params, opt_state = state["params"], state["opt"]
        resumed_from = latest

    step_fn = make_train_step(cfg, opt_cfg)

    start_step = (resumed_from or 0)
    pipe = Pipeline(data_cfg, start_step=start_step)
    result = TrainResult(final_step=start_step,
                         resumed_from=resumed_from)

    try:
        for step, batch in pipe:
            if step >= tcfg.total_steps:
                break
            batch = to_device(batch, dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if (step + 1) % tcfg.log_every == 0 or step == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["step"] = step
                metrics["step_seconds"] = time.perf_counter() - t0
                result.metrics_log.append(metrics)
            if (step + 1) % tcfg.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
            result.final_step = step + 1
            if (tcfg.fail_after_step is not None
                    and step + 1 >= tcfg.fail_after_step):
                raise PreemptionError(f"injected failure at {step + 1}")
    except BaseException:
        pipe.close()
        # the loop's error is the one to report, not a failed write's
        with contextlib.suppress(Exception):
            ckpt.wait()
        raise
    pipe.close()
    ckpt.wait()

    result.params, result.opt_state = params, opt_state
    return result

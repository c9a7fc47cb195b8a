"""Deterministic synthetic token pipeline with packing and prefetch.

The JAX package's pipeline, kept as a numpy copy so that the port
imports nothing of it: batch ``i`` is a pure function of (seed, i,
process index) and bitwise equal to the JAX package's, so a trainer
resumed from step N sees exactly the batches it would have seen, and
a resumed run reproduces the loss curve.  Per-host sharding slices the
global batch by process index; a background thread keeps ``prefetch``
batches ready.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 256
    eos_id: int = 1
    n_prefix_tokens: int = 0
    d_model: int = 0                  # for frontend-stub prefix embeds
    process_index: int = 0
    process_count: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.process_count == 0
        return self.global_batch // self.process_count


def _pack_documents(rng: np.random.Generator, cfg: DataConfig,
                    rows: int) -> np.ndarray:
    """Sample doc lengths ~ exp(mean) and pack them with EOS separators."""
    out = np.zeros((rows, cfg.seq_len), np.int32)
    for r in range(rows):
        pos = 0
        while pos < cfg.seq_len:
            dl = int(rng.exponential(cfg.mean_doc_len)) + 1
            dl = min(dl, cfg.seq_len - pos)
            out[r, pos:pos + dl] = rng.integers(
                2, cfg.vocab_size, dl, dtype=np.int64)
            pos += dl
            if pos < cfg.seq_len:
                out[r, pos] = cfg.eos_id
                pos += 1
    return out


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The batch for global step ``step`` (this host's slice)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.process_index]))
    rows = cfg.host_batch
    seq = _pack_documents(rng, cfg, rows)
    n_tok = cfg.seq_len - cfg.n_prefix_tokens
    batch = {
        "tokens": seq[:, :n_tok],
        "labels": np.concatenate(
            [seq[:, 1:], np.full((rows, 1), cfg.eos_id, np.int32)], 1),
        "mask": np.ones((rows, cfg.seq_len), np.float32),
    }
    if cfg.n_prefix_tokens:
        batch["prefix_embeds"] = rng.standard_normal(
            (rows, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
        batch["mask"][:, : cfg.n_prefix_tokens] = 0.0
    return batch


class Pipeline:
    """Double-buffered prefetching iterator over make_batch."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer,
                                        daemon=True)
        self._thread.start()

    def _producer(self):
        step = self._step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)

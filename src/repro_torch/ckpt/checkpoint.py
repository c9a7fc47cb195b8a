"""Atomic, async checkpointing of trees of tensors.

The JAX package's layout and properties (``repro/ckpt/checkpoint.py``)
for the port's trees (nested dicts, lists and ParamTrees).  Layout per
step::

    <dir>/step_00000042.tmp/      (written, fsynced)
        manifest.json             (keys, shapes, dtypes, step)
        shard_<host>.npz          (this host's leaf arrays)
    <dir>/step_00000042/          (atomic rename = commit)

Keys are tree paths joined with "/" (``params/layers/scan/0/0/mix/wq``).
numpy has no bfloat16, so a bf16 leaf is stored as its ``uint16`` bits
and the manifest records its dtype; every leaf round-trips bitwise.

Properties (tested):
  * atomic commit: a crash mid-write leaves only a .tmp dir, which
    restore ignores and GC removes;
  * async: ``save`` copies every leaf to host memory before it returns
    (the trainer updates its tensors in place next step), and a thread
    writes the copy; ``wait()`` joins it and raises its error;
  * keep-k GC;
  * restore places each leaf on the device and in the dtype of the
    tree it restores into, or, with ``shardings=``, as a DTensor on the
    mesh each leaf's NamedSharding names: a checkpoint saved by a world
    of 4 restores onto a world of 2 (elastic rescale).

A tree of DTensors (an SPMD rank's parameters) is saved in the JAX
package's single-controller layout: every rank gathers each leaf's
full tensor, rank 0 alone writes ``shard_0.npz``, and every rank waits
at a barrier before the commit and after it, so ``save`` returns on
every rank with the step committed.  That save is synchronous.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.common import _is_dtensor, named_leaves, tree_map


def _host_copy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy (bf16 as its uint16 bits) and the
    name of its torch dtype."""
    name = str(t.dtype).replace("torch.", "")
    host = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16), name
    return host.numpy(), name


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 process_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.process_index = process_index
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False) -> None:
        named = named_leaves(tree)
        if any(_is_dtensor(v) for _, v in named):
            self._save_spmd(step, named)
            return
        # snapshot to host memory NOW: the caller updates in place next
        leaves = [(k, *_host_copy(v)) for k, v in named]
        self.wait()

        def work():
            try:
                self._write(step, leaves)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _save_spmd(self, step: int, named) -> None:
        """Every rank gathers the full leaves (a collective); rank 0
        writes them; the commit sits between two barriers."""
        import torch.distributed as dist

        self.wait()
        leaves = [(k, *_host_copy(v.full_tensor() if _is_dtensor(v) else v))
                  for k, v in named]
        writer = dist.get_rank() == 0
        if writer:
            self._write(step, leaves, commit=False)
        dist.barrier()
        if writer:
            self._commit(step)
            self._gc()
        dist.barrier()

    def _write(self, step: int, leaves, commit: bool = True) -> None:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        shard = os.path.join(tmp, f"shard_{self.process_index}.npz")
        np.savez(shard, **{k: a for k, a, _ in leaves})
        manifest = {
            "step": step,
            "keys": [k for k, _, _ in leaves],
            "shapes": {k: list(a.shape) for k, a, _ in leaves},
            "dtypes": {k: d for k, _, d in leaves},
            "time": time.time(),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if commit:
            self._commit(step)

    def _commit(self, step: int) -> None:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic commit

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def _steps(self) -> List[int]:
        steps = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                steps.append(int(d.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _gc(self) -> None:
        steps = self._steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
        # drop stale tmp dirs from crashed writers
        for d in os.listdir(self.dir):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d),
                              ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, like_tree, step: Optional[int] = None,
                shardings=None):
        """(step, tree): checkpoint ``step`` (default the latest) in the
        structure of ``like_tree``, each leaf in the dtype of
        ``like_tree``'s leaf, requiring grad where it does, and on its
        device — or, with ``shardings`` (a matching tree of port
        ``NamedSharding``s, or one for every leaf), distributed onto
        the sharding's mesh from this SPMD rank; (None, None) when
        there is no checkpoint."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            dtypes = json.load(f)["dtypes"]
        keys = iter([k for k, _ in named_leaves(like_tree)])
        with np.load(os.path.join(
                d, f"shard_{self.process_index}.npz")) as data:
            def place(like: torch.Tensor) -> torch.Tensor:
                key = next(keys)
                t = _from_host(data[key], dtypes[key]).to(
                    device=like.device, dtype=like.dtype)
                return t.requires_grad_(like.requires_grad)

            tree = tree_map(place, like_tree)
        if shardings is not None:
            from ..launch.sharding import device_put
            tree = device_put(tree, shardings)
        return step, tree

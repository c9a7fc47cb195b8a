"""Budgeted cache of materialized covering relations — a thin pool view
over :class:`repro_torch.core.memory.MemoryManager`.

The MCKP decides *admission* offline (the paper's core departure from
eviction-based caching literature); this view enforces the budget at
materialization time.  Cardinality-estimation error can make the true
materialized size exceed the estimate — mirroring the paper (§6.3,
footnote 6-ii) the overflow takes the manager's spill path: device →
host (the Spark ``MEMORY_AND_DISK`` analog on a TPU is HBM → host DRAM
offload) → drop.

By default the view owns a private single-pool manager with the
``"admission"`` policy (residents are never evicted — pure paper
semantics).  Passing ``manager=`` instead registers the pool on a
shared :class:`MemoryManager`, where the session-level eviction policy
(``lru`` / ``benefit``) and the shared budget apply — the unified
memory hierarchy used by ``relational.Session`` and
``serving.ServingEngine``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

from .memory import MemoryEntry, MemoryManager, MemoryPool, PoolStats

# Backward-compatible aliases: entries and stats now live in the
# unified memory subsystem.
CacheEntry = MemoryEntry
CacheStats = PoolStats


class CacheTransaction:
    """All-or-nothing multi-entry admission.

    A partition-grained CE materializes as several ``(ψ, pid)`` entries;
    a fault part-way through must not leave the earlier partitions
    charged against the pool budget while the CE as a whole is unusable.
    Used as a context manager the transaction rolls back every entry it
    admitted when the block raises, and commits (keeps them) otherwise::

        with cache.transaction() as txn:
            for pid in pids:
                txn.put((psi, pid), tbl, nbytes)

    Rollback evicts through the manager's normal path, so the journal
    records the reversal and ``audit()`` stays clean either way.
    """

    def __init__(self, cache: "CacheManager"):
        self._cache = cache
        self._keys: List[Any] = []
        self.rolled_back = False

    def put(self, psi, payload: Any, nbytes: int,
            est_bytes: int = 0, benefit: float = 0.0) -> MemoryEntry:
        entry = self._cache.put(psi, payload, nbytes=nbytes,
                                est_bytes=est_bytes, benefit=benefit)
        self._keys.append(psi)
        return entry

    def rollback(self) -> int:
        """Evict every entry admitted by this transaction; returns how
        many were reversed."""
        n = 0
        for key in self._keys:
            self._cache.evict(key)
            n += 1
        self._keys.clear()
        self.rolled_back = True
        return n

    def commit(self) -> None:
        self._keys.clear()

    def __enter__(self) -> "CacheTransaction":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.rollback()
        else:
            self.commit()
        return False                 # never swallow the exception


class CacheManager:
    """Holds materialized CE outputs keyed by fingerprint ψ."""

    def __init__(self, budget_bytes: int,
                 spill_fn: Optional[Callable[[Any], Any]] = None,
                 unspill_fn: Optional[Callable[[Any], Any]] = None,
                 *,
                 manager: Optional[MemoryManager] = None,
                 pool: str = "ce",
                 policy: Optional[str] = None):
        if manager is None:
            manager = MemoryManager(int(budget_bytes),
                                    policy=policy or "admission")
        else:
            assert int(budget_bytes) == manager.device_budget, (
                "a pool view cannot enforce a budget different from its "
                "shared manager's device budget")
        self.manager = manager
        self.budget = manager.device_budget
        self._pool: MemoryPool = manager.pool(
            pool, spill_fn=spill_fn, unspill_fn=unspill_fn, policy=policy)

    # -- admission ---------------------------------------------------------
    def put(self, psi: bytes, payload: Any, nbytes: int,
            est_bytes: int = 0, benefit: float = 0.0) -> MemoryEntry:
        return self._pool.put(psi, payload, nbytes=nbytes,
                              est_bytes=est_bytes, benefit=benefit)

    # -- lookup ------------------------------------------------------------
    def get(self, psi: bytes) -> Optional[Any]:
        return self._pool.get(psi)

    def contains(self, psi: bytes) -> bool:
        return self._pool.contains(psi)

    def touch(self, psi: bytes) -> bool:
        return self._pool.touch(psi)

    def entry(self, psi: bytes) -> Optional[MemoryEntry]:
        return self._pool.entry(psi)

    def resident_psis(self) -> frozenset:
        """ψ of every entry still materialized (device or host tier) —
        the cross-batch reuse set the optimizer re-prices as
        already-paid."""
        return frozenset(self._pool.keys())

    def keys(self):
        """Every live cache key: whole-CE entries are ``bytes`` strict
        fingerprints, partition-grained entries are ``(strict, pid)``
        tuples (see relational.partition)."""
        return self._pool.keys()

    def transaction(self) -> CacheTransaction:
        """Open an all-or-nothing admission scope (see
        :class:`CacheTransaction`)."""
        return CacheTransaction(self)

    # -- maintenance ---------------------------------------------------------
    def evict(self, psi: bytes) -> None:
        self._pool.evict(psi)

    def clear(self) -> None:
        self._pool.clear()

    @property
    def stats(self) -> PoolStats:
        return self._pool.stats

    @property
    def used_bytes(self) -> int:
        return self._pool.used_bytes

    def report(self) -> dict:
        return self._pool.report()

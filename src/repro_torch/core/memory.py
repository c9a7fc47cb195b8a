"""Unified memory hierarchy: one budget-aware :class:`MemoryManager`.

The paper's MCKP formulation assumes a SINGLE memory budget governs
what gets materialized.  This module is that budget's runtime owner:
every byte of device-resident cached state — CE materializations
(``core.cache``), device scan columns (``relational.physical``),
serving prefix states (``serving.engine``) — is admitted through one
manager, partitioned into named *pools*.

Hierarchy (two spill tiers instead of the old binary spill):

    device (budgeted)  ──evict──▶  host (optionally budgeted)  ──▶  drop

* A put that does not fit evicts victims chosen by the pool's
  **eviction policy**:

    - ``"lru"``      least-recently-used first (logical clock);
    - ``"benefit"``  lowest benefit-per-byte first, where *benefit* is
      the caller-supplied savings estimate (the CostModel's Eq. 3 value
      for CEs, the transfer cost for scan columns) — the
      benefit-aware eviction of Yang et al. 2018;
    - ``"admission"`` no eviction of residents: the INCOMING entry
      spills (the paper's semantics — the MCKP already decided
      admission offline, residents are load-bearing).

* An evicted entry spills to the host tier when its pool has a
  ``spill_fn`` (HBM → host DRAM offload); pools without one (e.g. the
  scan cache, whose source host arrays still live in the catalog) drop
  the payload instead — a later get is a miss and the caller
  recomputes.

* A host-tier hit is unspilled and **promoted back to device when
  there is headroom** (fixing the old CacheManager's re-unspill-per-hit
  churn); without headroom the unspilled payload is returned but the
  entry stays on the host tier.

Invariants (property-tested in ``tests/test_memory.py``):

    device_used ≤ device_budget        after ANY op sequence
    host_used   ≤ host_budget          (when a host budget is set)
    *_used      == Σ nbytes of entries actually resident on that tier

Dropping or spilling never changes results — every consumer treats a
miss as "recompute from the retained plan" — so batches are
bit-identical under a pathologically tiny budget and an unlimited one.

**Failure model.**  Admissions, spills and evictions are
journaled two-phase operations: a :class:`Journal` record opens before
the books are touched and commits after — an exception escaping
mid-operation leaves an open record that :meth:`MemoryManager.audit`
flags instead of silently corrupting ``used`` counters.  ``audit()``
re-derives every invariant from the entries actually present
(``used ≤ budget``, tier bookkeeping matches residency, no orphaned or
transient-tier entries) and returns the violations;
:meth:`MemoryManager.reconcile` *quarantines-then-drops* inconsistent
entries and recomputes the books from the survivors, so a corrupt
entry is never served.  ``get`` applies the same guard inline: an
entry in an impossible state is quarantined and reported as a miss.
A spill that fails (the ``spill_to_host`` fault point, or a raising
``spill_fn``) degrades to a drop — the victim's consumers recompute,
results are unchanged, and the books stay exact.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

POLICIES = ("lru", "benefit", "admission")

DEVICE, HOST, DROPPED = "device", "host", "dropped"
# transient tier label used inside _make_room while a victim is between
# tiers; must never be observable between operations (audit flags it)
EVICTING = "evicting"


@dataclass
class MemoryEntry:
    key: Any
    pool: str
    payload: Any
    nbytes: int
    est_bytes: int = 0
    benefit: float = 0.0          # savings estimate (policy="benefit")
    tier: str = DEVICE            # "device" | "host" | "dropped"
    hits: int = 0
    seq: int = 0                  # logical clock (policy="lru")
    created_at: float = field(default_factory=time.monotonic)
    # per-tenant attribution: the tenant whose query first
    # materialized this entry ("first-toucher pays"); None == shared /
    # untenanted.  Attribution only — eviction stays tenant-blind.
    owner: Optional[str] = None

    @property
    def spilled(self) -> bool:    # CacheEntry-compat view
        return self.tier == HOST

    @property
    def psi(self):                # CacheEntry-compat view
        return self.key


@dataclass
class JournalRecord:
    """One two-phase pool operation: opened before the books move,
    committed after.  An open record surviving past its operation means
    the op died mid-flight — ``audit()`` reports it, ``reconcile()``
    closes it after repairing the books."""

    seq: int
    op: str                       # "put" | "evict" | "promote" | ...
    pool: str
    key: Any
    committed: bool = False
    note: str = ""


class Journal:
    """Bounded journal of pool operations (ring buffer — telemetry and
    crash detection, not a redo log; the books themselves are repaired
    by recomputation from entries in ``reconcile``)."""

    def __init__(self, maxlen: int = 512):
        self.records: deque = deque(maxlen=maxlen)
        self._open: Dict[int, JournalRecord] = {}
        self._seq = 0

    def begin(self, op: str, pool: str, key: Any) -> JournalRecord:
        self._seq += 1
        rec = JournalRecord(seq=self._seq, op=op, pool=pool, key=key)
        self.records.append(rec)
        self._open[rec.seq] = rec
        return rec

    def commit(self, rec: JournalRecord, note: str = "") -> None:
        rec.committed = True
        if note:
            rec.note = note
        self._open.pop(rec.seq, None)

    def open_records(self) -> List[JournalRecord]:
        return list(self._open.values())


@dataclass
class PoolStats:
    """Per-pool accounting (field names match the old CacheStats)."""

    budget: int = 0               # the manager's device budget
    used: int = 0                 # this pool's device-tier bytes
    spilled_bytes: int = 0        # this pool's host-tier bytes
    admissions: int = 0
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    drops: int = 0
    promotions: int = 0
    spill_failures: int = 0       # spills downgraded to drops

    def as_dict(self) -> dict:
        return dict(budget=self.budget, used=self.used,
                    spilled_bytes=self.spilled_bytes,
                    admissions=self.admissions, hits=self.hits,
                    misses=self.misses, evictions=self.evictions,
                    drops=self.drops, promotions=self.promotions,
                    spill_failures=self.spill_failures)


class MemoryPool:
    """A named view over the manager: one keyspace, one spill path."""

    def __init__(self, manager: "MemoryManager", name: str,
                 spill_fn: Optional[Callable[[Any], Any]] = None,
                 unspill_fn: Optional[Callable[[Any], Any]] = None,
                 policy: Optional[str] = None):
        self.manager = manager
        self.name = name
        self.spill_fn = spill_fn
        self.unspill_fn = unspill_fn
        self.policy = policy or manager.policy
        assert self.policy in POLICIES, self.policy
        self.entries: Dict[Any, MemoryEntry] = {}
        self.stats = PoolStats(budget=manager.device_budget)

    # -- delegated operations ------------------------------------------------
    def put(self, key, payload, nbytes: int, est_bytes: int = 0,
            benefit: float = 0.0) -> MemoryEntry:
        return self.manager.put(self, key, payload, nbytes,
                                est_bytes=est_bytes, benefit=benefit)

    def get(self, key, default=None):
        return self.manager.get(self, key, default)

    def touch(self, key) -> bool:
        """Presence check that refreshes LRU recency (counted as a hit)
        without unspilling or promoting — for callers that only need to
        know the entry exists and will read the payload later."""
        entry = self.entries.get(key)
        if entry is None:
            return False
        self.manager._seq += 1
        entry.seq = self.manager._seq
        entry.hits += 1
        self.stats.hits += 1
        return True

    def contains(self, key) -> bool:
        return key in self.entries

    def __contains__(self, key) -> bool:
        return key in self.entries

    def entry(self, key) -> Optional[MemoryEntry]:
        return self.entries.get(key)

    def evict(self, key) -> None:
        self.manager.evict(self, key)

    def invalidate(self, pred: Callable[[Any], bool]) -> int:
        """Drop every entry whose key matches ``pred``; returns count."""
        victims = [k for k in self.entries if pred(k)]
        for k in victims:
            self.manager.evict(self, k)
        return len(victims)

    def clear(self) -> None:
        for k in list(self.entries):
            self.manager.evict(self, k)
        # counters other than occupancy survive a clear (they are
        # lifetime telemetry); occupancy is zeroed by the evictions

    def keys(self) -> Iterable:
        return self.entries.keys()

    @property
    def used_bytes(self) -> int:
        return self.stats.used

    def report(self) -> dict:
        return {
            **self.stats.as_dict(),
            "entries": [
                dict(psi=_short_key(e.key), nbytes=e.nbytes,
                     est_bytes=e.est_bytes, spilled=e.spilled,
                     hits=e.hits)
                for e in self.entries.values()
            ],
        }


class MemoryManager:
    """Owns the device-byte budget shared by every registered pool."""

    def __init__(self, device_budget: int,
                 host_budget: Optional[int] = None,
                 policy: str = "lru"):
        assert policy in POLICIES, policy
        self.device_budget = int(device_budget)
        self.host_budget = None if host_budget is None else int(host_budget)
        self.policy = policy
        self.pools: Dict[str, MemoryPool] = {}
        self.device_used = 0
        self.host_used = 0
        self._seq = 0
        self.journal = Journal()
        # optional core.faults.FaultInjector (the "spill_to_host" point);
        # installed by the owning Session when fault injection is on
        self.faults = None
        self.quarantined = 0      # entries dropped by the serving guard
        # optional relational.observe.Telemetry; when set, the session's
        # metrics registry mirrors eviction / spill / drop events live
        # (per-pool lifetime books stay in PoolStats regardless)
        self.telemetry = None
        # per-tenant attribution: admissions while an owner is
        # set (see ``owning``) stamp the entry with it
        self.current_owner: Optional[str] = None

    @contextmanager
    def owning(self, owner: Optional[str]):
        """Scope during which admissions are attributed to ``owner``
        (the async front wraps each query's execution in the tenant
        that submitted it).  ``None`` attributes to the shared pool."""
        prev = self.current_owner
        self.current_owner = owner
        try:
            yield
        finally:
            self.current_owner = prev

    def owner_usage(self) -> Dict[str, Dict[str, int]]:
        """``{owner: {pool: resident bytes}}`` over live (device + host)
        entries — recomputed from the entries themselves on every call,
        so attribution can never drift from the books the audit checks.
        Entries with no owner (untenanted work) are omitted."""
        out: Dict[str, Dict[str, int]] = {}
        for name, pool in self.pools.items():
            # list(): admissions may race this read from another thread
            # (the async front's executor); a point-in-time copy is all
            # attribution needs
            for e in list(pool.entries.values()):
                if e.owner is None or e.tier not in (DEVICE, HOST):
                    continue
                by_pool = out.setdefault(e.owner, {})
                by_pool[name] = by_pool.get(name, 0) + e.nbytes
        return out

    def owner_bytes(self, owner: str) -> int:
        """Total live bytes attributed to ``owner`` across all pools
        (the quantity a TenantQuota's ``max_bytes`` is charged against)."""
        return sum(self.owner_usage().get(owner, {}).values())

    def _tinc(self, name: str, n: float = 1) -> None:
        tel = self.telemetry
        if tel is not None:
            tel.registry.inc(name, n)

    # -- pool registry -------------------------------------------------------
    def pool(self, name: str, *,
             spill_fn: Optional[Callable[[Any], Any]] = None,
             unspill_fn: Optional[Callable[[Any], Any]] = None,
             policy: Optional[str] = None) -> MemoryPool:
        """Get-or-create the named pool (idempotent; first caller wins
        the configuration)."""
        p = self.pools.get(name)
        if p is None:
            p = self.pools[name] = MemoryPool(
                self, name, spill_fn=spill_fn, unspill_fn=unspill_fn,
                policy=policy)
        return p

    # -- admission -----------------------------------------------------------
    def put(self, pool: MemoryPool, key, payload, nbytes: int,
            est_bytes: int = 0, benefit: float = 0.0) -> MemoryEntry:
        nbytes = int(nbytes)
        rec = self.journal.begin("put", pool.name, key)
        if key in pool.entries:          # re-put invalidates the old entry
            self.evict(pool, key)
        self._seq += 1
        entry = MemoryEntry(key=key, pool=pool.name, payload=payload,
                            nbytes=nbytes, est_bytes=int(est_bytes),
                            benefit=float(benefit), seq=self._seq,
                            owner=self.current_owner)
        pool.stats.admissions += 1

        if self.device_used + nbytes > self.device_budget:
            # admission pools protect their own residents (victim
            # selection skips them) but may still displace entries of
            # evictable pools; when nothing can be freed the INCOMING
            # entry takes the spill path
            self._make_room(nbytes)

        if self.device_used + nbytes <= self.device_budget:
            self.device_used += nbytes
            pool.stats.used += nbytes
            pool.entries[key] = entry
        else:
            # could not free enough (entry bigger than the whole budget,
            # or every resident is admission-pinned)
            self._demote(pool, entry)
            if entry.tier != DROPPED:
                pool.entries[key] = entry
        self.journal.commit(rec, note=entry.tier)
        return entry

    # -- lookup --------------------------------------------------------------
    def get(self, pool: MemoryPool, key, default=None):
        entry = pool.entries.get(key)
        if entry is None:
            pool.stats.misses += 1
            return default
        if entry.tier not in (DEVICE, HOST) or entry.payload is None:
            # serving guard: an entry stranded in an impossible state
            # (a crashed mid-operation) must not be served — quarantine
            # it (drop + repair the books) and report a miss so the
            # caller recomputes from the retained plan
            self._quarantine(pool, entry)
            pool.stats.misses += 1
            return default
        self._seq += 1
        entry.seq = self._seq
        entry.hits += 1
        pool.stats.hits += 1
        if entry.tier == DEVICE:
            return entry.payload
        # host tier: unspill, promoting back to device when there is
        # headroom (the old manager re-unspilled on EVERY hit and never
        # promoted — the satellite-1 churn fix).  Without an unspill_fn
        # the payload stays in host form, so it must not be relabeled
        # (and re-accounted) as device-resident.
        if pool.unspill_fn is None:
            return entry.payload
        payload = pool.unspill_fn(entry.payload)
        if self.device_used + entry.nbytes <= self.device_budget:
            rec = self.journal.begin("promote", pool.name, key)
            entry.payload = payload
            entry.tier = DEVICE
            self.host_used -= entry.nbytes
            self.device_used += entry.nbytes
            pool.stats.spilled_bytes -= entry.nbytes
            pool.stats.used += entry.nbytes
            pool.stats.promotions += 1
            self.journal.commit(rec)
        return payload

    # -- maintenance ---------------------------------------------------------
    def evict(self, pool: MemoryPool, key) -> None:
        entry = pool.entries.pop(key, None)
        if entry is None:
            return
        rec = self.journal.begin("evict", pool.name, key)
        self._release(pool, entry)
        entry.tier = DROPPED
        entry.payload = None
        self.journal.commit(rec)

    def clear(self) -> None:
        for p in self.pools.values():
            p.clear()

    @property
    def device_headroom(self) -> int:
        return max(0, self.device_budget - self.device_used)

    # -- self-audit ----------------------------------------------------------
    def audit(self) -> List[str]:
        """Verify every pool invariant from first principles and return
        the violations (empty list == clean).  Checks, per pool and for
        the manager totals:

        * ``used ≤ budget`` on both tiers;
        * tier bookkeeping matches actual residency (``stats.used`` ==
          Σ nbytes of entries actually on the device tier, ditto host);
        * no orphaned buffers (an entry on a live tier with a ``None``
          payload) and no entries stranded on a transient tier
          (``evicting`` / ``dropped`` ghosts left in the key map);
        * no journal record still open (a crashed mid-operation).
        """
        v: List[str] = []
        dev_total = host_total = 0
        for name, pool in self.pools.items():
            dev = host = 0
            for e in pool.entries.values():
                if e.tier == DEVICE:
                    dev += e.nbytes
                elif e.tier == HOST:
                    host += e.nbytes
                else:
                    v.append(f"{name}: entry {_short_key(e.key)} stranded"
                             f" on transient tier {e.tier!r}")
                if e.tier in (DEVICE, HOST) and e.payload is None:
                    v.append(f"{name}: orphaned {e.tier} buffer for "
                             f"{_short_key(e.key)} (payload is None)")
            if dev != pool.stats.used:
                v.append(f"{name}: device books {pool.stats.used} != "
                         f"actual residency {dev}")
            if host != pool.stats.spilled_bytes:
                v.append(f"{name}: host books {pool.stats.spilled_bytes}"
                         f" != actual residency {host}")
            dev_total += dev
            host_total += host
        if dev_total != self.device_used:
            v.append(f"manager: device_used {self.device_used} != "
                     f"Σ pool residency {dev_total}")
        if host_total != self.host_used:
            v.append(f"manager: host_used {self.host_used} != "
                     f"Σ pool residency {host_total}")
        if self.device_used > self.device_budget:
            v.append(f"manager: device_used {self.device_used} > "
                     f"budget {self.device_budget}")
        if (self.host_budget is not None
                and self.host_used > self.host_budget):
            v.append(f"manager: host_used {self.host_used} > "
                     f"host budget {self.host_budget}")
        for rec in self.journal.open_records():
            v.append(f"journal: {rec.op} on {rec.pool}/"
                     f"{_short_key(rec.key)} (seq {rec.seq}) never "
                     f"committed — operation died mid-flight")
        return v

    def reconcile(self) -> dict:
        """Repair after a failed operation: quarantine-then-drop every
        entry in an inconsistent state (transient tier, orphaned
        payload), recompute the books from the surviving entries, and
        close crashed journal records.  Returns a report of what was
        repaired; ``audit()`` is clean afterwards by construction —
        quarantined content is recomputed by its consumers, never
        served."""
        quarantined: List[str] = []
        for name, pool in self.pools.items():
            bad = [e for e in pool.entries.values()
                   if e.tier not in (DEVICE, HOST) or e.payload is None]
            for e in bad:
                pool.entries.pop(e.key, None)
                e.tier = DROPPED
                e.payload = None
                quarantined.append(f"{name}/{_short_key(e.key)}")
            self.quarantined += len(bad)
        # recompute every book from actual residency
        corrections = 0
        dev_total = host_total = 0
        for pool in self.pools.values():
            dev = sum(e.nbytes for e in pool.entries.values()
                      if e.tier == DEVICE)
            host = sum(e.nbytes for e in pool.entries.values()
                       if e.tier == HOST)
            corrections += (dev != pool.stats.used)
            corrections += (host != pool.stats.spilled_bytes)
            pool.stats.used = dev
            pool.stats.spilled_bytes = host
            dev_total += dev
            host_total += host
        corrections += (dev_total != self.device_used)
        corrections += (host_total != self.host_used)
        self.device_used = dev_total
        self.host_used = host_total
        crashed = self.journal.open_records()
        for rec in crashed:
            self.journal.commit(rec, note="closed by reconcile")
        # a recomputation cannot shrink usage below the budget if the
        # surviving residency genuinely exceeds it — evict down to the
        # budget through the normal victim path in that case
        if self.device_used > self.device_budget:
            self._make_room(0)
        return {
            "quarantined": quarantined,
            "corrections": int(corrections),
            "crashed_ops": len(crashed),
        }

    def _quarantine(self, pool: MemoryPool, entry: MemoryEntry) -> None:
        """Serving-side guard: remove a corrupt entry and repair the
        books it may have skewed (used by ``get`` before it would have
        served the entry)."""
        pool.entries.pop(entry.key, None)
        if entry.tier == DEVICE:
            self.device_used -= entry.nbytes
            pool.stats.used -= entry.nbytes
        elif entry.tier == HOST:
            self.host_used -= entry.nbytes
            pool.stats.spilled_bytes -= entry.nbytes
        entry.tier = DROPPED
        entry.payload = None
        self.quarantined += 1

    def report(self) -> dict:
        return {
            "device_budget": self.device_budget,
            "device_used": self.device_used,
            "host_budget": self.host_budget,
            "host_used": self.host_used,
            "policy": self.policy,
            "pools": {n: p.report() for n, p in self.pools.items()},
        }

    # -- internals -----------------------------------------------------------
    def _release(self, pool: MemoryPool, entry: MemoryEntry) -> None:
        if entry.tier == DEVICE:
            self.device_used -= entry.nbytes
            pool.stats.used -= entry.nbytes
        elif entry.tier == HOST:
            self.host_used -= entry.nbytes
            pool.stats.spilled_bytes -= entry.nbytes

    def _victim_score(self, e: MemoryEntry):
        """Ascending victim order: (policy primary, recency).  Benefit
        pools rank by benefit-per-byte; lru pools rank purely by
        recency (primary 0.0 — recomputable state goes first when mixed
        with benefit-ranked pools)."""
        if self.pools[e.pool].policy == "benefit":
            return (e.benefit / max(e.nbytes, 1), e.seq)
        return (0.0, e.seq)

    def _make_room(self, nbytes: int) -> None:
        """Evict device victims (policy order, across evictable pools)
        until ``nbytes`` fits or nothing evictable remains.  The
        incoming entry is not yet in any pool, so it can never be its
        own victim."""
        if nbytes > self.device_budget:
            # can never fit: don't flush residents for nothing — the
            # caller sends the oversized entry down the spill path
            return
        candidates = [
            e for p in self.pools.values() if p.policy != "admission"
            for e in p.entries.values()
            if e.tier == DEVICE
        ]
        candidates.sort(key=self._victim_score)
        for victim in candidates:
            if self.device_used + nbytes <= self.device_budget:
                break
            vpool = self.pools[victim.pool]
            self.device_used -= victim.nbytes
            vpool.stats.used -= victim.nbytes
            vpool.stats.evictions += 1
            self._tinc(f"mem.evictions.{vpool.name}")
            victim.tier = "evicting"   # transient: not on any tier
            self._demote(vpool, victim)
            if victim.tier == DROPPED:
                del vpool.entries[victim.key]

    def _make_host_room(self, nbytes: int) -> None:
        if self.host_budget is None or nbytes > self.host_budget:
            # unbounded tier, or an entry that can never fit (the
            # caller drops it): never flush the host tier for nothing
            return
        candidates = [
            e for p in self.pools.values()
            for e in p.entries.values() if e.tier == HOST
        ]
        candidates.sort(key=self._victim_score)
        for victim in candidates:
            if self.host_used + nbytes <= self.host_budget:
                break
            vpool = self.pools[victim.pool]
            self.host_used -= victim.nbytes
            vpool.stats.spilled_bytes -= victim.nbytes
            vpool.stats.drops += 1
            self._tinc(f"mem.drops.{vpool.name}")
            victim.tier = DROPPED
            del vpool.entries[victim.key]

    def _demote(self, pool: MemoryPool, entry: MemoryEntry) -> None:
        """Tier 2/3 of the spill path: host when the pool can spill and
        the host budget allows, else drop.  A spill that fails — the
        ``spill_to_host`` fault point or a raising ``spill_fn`` — is
        DOWNGRADED to a drop instead of escaping: the victim's consumers
        recompute from the retained plan (results unchanged) and the
        books never see a half-spilled entry."""
        if pool.spill_fn is not None:
            self._make_host_room(entry.nbytes)
            if (self.host_budget is None
                    or self.host_used + entry.nbytes <= self.host_budget):
                rec = self.journal.begin("spill", pool.name, entry.key)
                try:
                    if self.faults is not None:
                        self.faults.check("spill_to_host", key=entry.key)
                    payload = pool.spill_fn(entry.payload)
                except Exception as exc:   # incl. InjectedFault
                    pool.stats.spill_failures += 1
                    self._tinc(f"mem.spill_failures.{pool.name}")
                    self.journal.commit(rec, note=f"failed: {exc!r}")
                else:
                    entry.payload = payload
                    entry.tier = HOST
                    self.host_used += entry.nbytes
                    pool.stats.spilled_bytes += entry.nbytes
                    self._tinc(f"mem.spills.{pool.name}")
                    self._tinc(f"mem.spilled_bytes.{pool.name}",
                               entry.nbytes)
                    self.journal.commit(rec)
                    return
        entry.payload = None
        entry.tier = DROPPED
        pool.stats.drops += 1
        self._tinc(f"mem.drops.{pool.name}")


class PidPool:
    """Partition-identifier bitset pool — the hierarchy's fourth pool
    (``"pid"``, after ``ce`` / ``scan`` / ``prefix``).

    One entry per ``(table, canonical-conjunct)``: a bitset over the
    table's partitions recording which of them produced ANY row when a
    scan actually evaluated that predicate (populated as a side effect
    of fused/batched execution).  A bitset is ``(n_partitions + 7) // 8``
    bytes — orders of magnitude cheaper than the materialized rows it
    summarizes (PartitionCache's observation) — so entries practically
    never face eviction, yet later conjunctive queries can intersect
    them to prune partitions by observed *history* on top of what
    min/max statistics can refute.

    Soundness contract (enforced by the recording side): a recorded
    bitset's ABSENT partitions held zero qualifying rows for the stored
    predicate over the whole table — partitions the recording scan
    itself pruned count as absent only because pruning is conservative
    (a pruned partition is exactly empty for the predicate).  Hence for
    any query predicate *q* with rows(q) ⊆ rows(p), absent partitions
    are empty for *q* too, and intersecting is exact, never lossy.

    The core stays plan-agnostic: predicates are opaque payloads and
    the "does stored *p* subsume query *q*" decision is delegated to the
    ``implies`` callable the caller passes to :meth:`intersect` (the
    relational layer closes ``canonical.subsumes`` over the table
    schema).
    """

    POOL = "pid"

    def __init__(self, manager: "MemoryManager",
                 policy: Optional[str] = None):
        # no spill_fn: a bitset is cheaper to recompute (one scan) than
        # to stage through the host tier, and entries are tiny anyway
        self._pool = manager.pool(self.POOL, policy=policy)

    @staticmethod
    def _nbytes(n_partitions: int) -> int:
        return max(1, (int(n_partitions) + 7) // 8)

    # -- recording -----------------------------------------------------------
    def record(self, table: str, pred_key, pred, n_partitions: int,
               present: Iterable[int]) -> MemoryEntry:
        """Admit the observed presence set for ``(table, pred_key)``.
        ``pred`` rides along as payload so later lookups can test
        subsumption against the stored predicate object."""
        mask = 0
        for pid in present:
            mask |= 1 << int(pid)
        return self._pool.put(
            (table, pred_key), (mask, int(n_partitions), pred),
            nbytes=self._nbytes(n_partitions))

    def contains(self, table: str, pred_key) -> bool:
        return self._pool.contains((table, pred_key))

    # -- lookup --------------------------------------------------------------
    def intersect(self, table: str, pred_key, pred, n_partitions: int,
                  live: Iterable[int], implies=None):
        """Shrink ``live`` by every resident bitset whose stored
        predicate provably subsumes ``pred`` (exact-key entries match
        without the subsumption test).  Returns ``(pruned ascending
        pid tuple, n_bitsets_used)`` — with no usable bitset the input
        comes back unchanged (history composes with, never overrides,
        the stats pruner that produced ``live``)."""
        out = {int(p) for p in live}
        hits = 0
        for key, entry in list(self._pool.entries.items()):
            if not (isinstance(key, tuple) and len(key) == 2
                    and key[0] == table):
                continue
            payload = entry.payload
            if payload is None:
                continue
            mask, n_parts, stored = payload
            if int(n_parts) != int(n_partitions):
                continue     # stale layout (belt: invalidated on register)
            if key[1] == pred_key:
                usable = True
            elif implies is not None:
                usable = bool(implies(stored, pred))
            else:
                usable = False
            if not usable:
                continue
            out = {p for p in out if (mask >> p) & 1}
            self._pool.touch(key)
            hits += 1
        return tuple(sorted(out)), hits

    # -- maintenance ---------------------------------------------------------
    def invalidate_table(self, table: str) -> int:
        """Drop every bitset of ``table`` (re-register: old data's
        observed history must not prune the new data's partitions)."""
        return self._pool.invalidate(
            lambda k: isinstance(k, tuple) and len(k) == 2
            and k[0] == table)

    def clear(self) -> None:
        self._pool.clear()

    def keys(self) -> Iterable:
        return self._pool.keys()

    @property
    def used_bytes(self) -> int:
        return self._pool.used_bytes

    @property
    def stats(self) -> PoolStats:
        return self._pool.stats

    def report(self) -> dict:
        return self._pool.report()


def _short_key(key) -> str:
    if isinstance(key, bytes):
        return key.hex()[:12]
    return str(key)[:48]

"""Deterministic fault injection: named failure points on the critical
path, driven by a seeded schedule.

Shared-work execution couples failure domains: one poisoned query, one
OOM during CE materialization, or one transient device failure can take
down a whole MQO window and strand bytes in the memory pools.  The
resilience layer (per-query isolation in ``relational.service``, the
degradation ladder in ``relational.executor``, transactional pools in
``core.memory``) exists to prevent exactly that — and every one of its
paths must be *property-tested rather than hoped-for*.  This module is
the test harness: each named :data:`FAULT_POINTS` site calls
``injector.check(point)`` on the hot path, and a seeded
:class:`FaultSchedule` decides deterministically whether that
invocation raises :class:`InjectedFault`.

Two scheduling modes, freely combined per point:

* **Bernoulli** — ``rate`` (global) / ``rates[point]`` (override): each
  invocation of the point fires independently with that probability,
  drawn from a per-point ``random.Random`` stream seeded by
  ``(seed, point)``.  The decision sequence is a pure function of the
  seed and the per-point invocation count, so the same workload replays
  the same faults.
* **Explicit** — ``schedule[point] = (i, j, ...)``: fire exactly at the
  given 0-based invocation indices of that point (targeted tests, e.g.
  "fail the SECOND partition admission of this CE").

Named points (wired in ``relational.physical`` / ``core.memory`` /
``relational.service``):

    ``scan_h2d``       host→device transfer of scan columns
    ``kernel_launch``  fused-pipeline dispatch (Pallas or fused-XLA)
    ``batched_launch`` a window's SHARED batched mask dispatch (fires
                       once per window when >= 2 plans are batchable;
                       the window degrades to per-query dispatch)
    ``ce_admission``   CE materialization entering the cache pool
    ``spill_to_host``  device→host spill of an eviction victim
    ``window_close``   the service's window close/execute step
    ``pid_pool``       a partition-ID bitset read; a failure
                       degrades to stats-only pruning — a pid hit is an
                       optimization, never a failure domain
    ``async_close``    the async front's background window-closer task
                       closing a deadline-expired window; a
                       fire crashes the closer task — the supervisor
                       restarts it and the due window closes on the
                       next pass, so every pending handle still
                       resolves

Configuration rides on ``SessionConfig.resilience.faults`` (a
:class:`FaultConfig`); a session without one injects nothing and pays
only an attribute check per site.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

FAULT_POINTS = ("scan_h2d", "kernel_launch", "batched_launch",
                "ce_admission", "spill_to_host", "window_close",
                "pid_pool", "async_close")


class TransientError(RuntimeError):
    """Base for failures the resilience layer may retry: the operation
    is expected to succeed on a later attempt (transient device/transfer
    faults).  Non-transient exceptions (a genuinely poisoned query) are
    not retried beyond the degradation ladder's bounded attempts."""


class InjectedFault(TransientError):
    """A scheduled failure fired at a named fault point."""

    def __init__(self, point: str, index: int, key=None):
        self.point = point
        self.index = index          # per-point invocation index
        self.key = key              # site detail (e.g. CE fingerprint)
        detail = f", key={key!r}" if key is not None else ""
        super().__init__(
            f"injected fault at {point!r} (invocation {index}{detail})")


@dataclass(frozen=True)
class FaultConfig:
    """Seeded fault schedule (``SessionConfig.resilience.faults``).

    ``rate`` is the default per-invocation Bernoulli probability for
    every point; ``rates`` overrides it per point; ``schedule`` adds
    exact invocation indices that always fire.  ``max_faults`` bounds
    the total number of fires (a soak can guarantee forward progress).
    """

    seed: int = 0
    rate: float = 0.0
    rates: Optional[Mapping[str, float]] = None
    schedule: Optional[Mapping[str, Tuple[int, ...]]] = None
    max_faults: Optional[int] = None

    def __post_init__(self):
        for pt in (self.rates or {}):
            assert pt in FAULT_POINTS, f"unknown fault point {pt!r}"
        for pt in (self.schedule or {}):
            assert pt in FAULT_POINTS, f"unknown fault point {pt!r}"

    @property
    def enabled(self) -> bool:
        return (self.rate > 0.0 or bool(self.rates)
                or bool(self.schedule))


@dataclass
class FaultRecord:
    point: str
    index: int
    key: object = None


class FaultInjector:
    """Runtime half of the schedule: per-point invocation counters plus
    the seeded decision streams.  ``check`` is the only hot-path call;
    everything else is telemetry for tests and window reports."""

    def __init__(self, config: FaultConfig):
        self.config = config
        self._counts: Dict[str, int] = {p: 0 for p in FAULT_POINTS}
        self._rngs: Dict[str, random.Random] = {
            p: random.Random(f"{config.seed}:{p}") for p in FAULT_POINTS}
        self._scheduled = {p: frozenset(v) for p, v in
                           (config.schedule or {}).items()}
        self.fired: List[FaultRecord] = []
        self.suppressed = 0         # fires skipped past max_faults
        # optional core.telemetry.MetricsRegistry; when set, every
        # check() mirrors its outcome into fault.* counters so soak
        # tests can assert fault/degradation counts from one place
        self.registry = None

    @classmethod
    def from_config(cls, config: Optional[FaultConfig]
                    ) -> Optional["FaultInjector"]:
        if config is None or not config.enabled:
            return None
        return cls(config)

    def _rate(self, point: str) -> float:
        rates = self.config.rates
        if rates is not None and point in rates:
            return float(rates[point])
        return float(self.config.rate)

    def check(self, point: str, key=None) -> None:
        """Count one invocation of ``point``; raise :class:`InjectedFault`
        when the schedule says this one fails.  The Bernoulli stream is
        advanced on EVERY invocation (fired or not), so the decision
        sequence depends only on the seed and the invocation index —
        not on which earlier faults were caught or retried."""
        assert point in FAULT_POINTS, f"unknown fault point {point!r}"
        index = self._counts[point]
        self._counts[point] = index + 1
        reg = self.registry
        if reg is not None:
            reg.inc(f"fault.invocations.{point}")
        draw = self._rngs[point].random()
        fire = index in self._scheduled.get(point, frozenset())
        rate = self._rate(point)
        if not fire and rate > 0.0:
            fire = draw < rate
        if not fire:
            return
        mx = self.config.max_faults
        if mx is not None and len(self.fired) >= mx:
            self.suppressed += 1
            if reg is not None:
                reg.inc("fault.suppressed")
            return
        rec = FaultRecord(point=point, index=index, key=key)
        self.fired.append(rec)
        if reg is not None:
            reg.inc(f"fault.fired.{point}")
            reg.inc("fault.fired.total")
        raise InjectedFault(point, index, key=key)

    # -- telemetry -----------------------------------------------------------
    @property
    def n_fired(self) -> int:
        return len(self.fired)

    def invocations(self, point: str) -> int:
        return self._counts[point]

    def fired_by_point(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.fired:
            out[rec.point] = out.get(rec.point, 0) + 1
        return out

    def report(self) -> dict:
        return {
            "seed": self.config.seed,
            "invocations": dict(self._counts),
            "fired": self.fired_by_point(),
            "n_fired": self.n_fired,
            "suppressed": self.suppressed,
        }


@dataclass
class DegradationEvent:
    """One step of a query's journey down the resilience ladder —
    collected into the window report (``BatchResult.resilience``) and
    the failed handle's ``explain()``."""

    query: int                    # position in the window
    attempt: int                  # 1-based execution attempt
    action: str                   # "retry" | "degrade" | "fallback" | ...
    level: str                    # route after the action
    error: str = ""               # repr of the triggering exception
    detail: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return dict(query=self.query, attempt=self.attempt,
                    action=self.action, level=self.level,
                    error=self.error, **self.detail)

"""CE value / weight pricing (paper §4.2, Equations 1–3).

The cost model is abstract here: a concrete :class:`CostModel` knows how
to price the execution of a sub-tree (CPU + disk + network), the cost of
materializing ``n`` output bytes into the cache, and the cost of reading
them back.  ``repro_torch.relational.stats`` supplies the SparkSQL-analog
implementation (cardinality-estimation based); ``repro_torch.serving`` supplies
a FLOPs/HBM-based one for prefix caching.

    C(ω_i) = Σ_j C_E(τ_j)                                     (Eq. 1)
    C(Ω_i) = C_E(τ*_i) + C_W(|τ*_i|) + m · C_R(|τ*_i|)        (Eq. 2)
    v(Ω_i) = C(ω_i) − C(Ω_i)                                  (Eq. 3)
    w(Ω_i) = |τ*_i|  (bytes of the materialized output)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence

from .covering import CoveringExpression
from .plan import PlanNode


class CostModel(Protocol):
    def execution_cost(self, tree: PlanNode) -> float:
        """C_E(τ): estimated cost of computing τ's output from scratch."""
        ...

    def output_rows(self, tree: PlanNode) -> int:
        """Estimated output cardinality |τ| in rows (or tokens)."""
        ...

    def output_bytes(self, tree: PlanNode) -> int:
        """Estimated materialized size of τ's output, in bytes."""
        ...

    def write_cost(self, tree: PlanNode) -> float:
        """C_W(|τ|): cost of materializing the output into the cache."""
        ...

    def read_cost(self, tree: PlanNode) -> float:
        """C_R(|τ|): cost of one consumer reading the cached output."""
        ...

    # Optional: concrete models may also provide
    #   extraction_cost(tree, member) -> float
    # pricing the per-consumer residual work (re-applying the member's
    # own filter/project over the cached CE output — one fused pipeline
    # pass in the relational engine).  When absent, consumers are priced
    # as m bare cache reads, which overvalues CEs whose members diverge
    # from the covering expression.
    #
    # Optional: concrete models may also provide
    #   calibration() -> dict
    # the predicted-vs-measured accuracy report assembled from an
    # attached CalibrationLog (set ``model.calibration_log``) — see
    # below.  repro_torch.relational.stats.RelationalCostModel implements it.


# ---------------------------------------------------------------------------
# cost-model accuracy accounting
# ---------------------------------------------------------------------------
@dataclass
class CalibrationSample:
    """One predicted-vs-measured observation: a CE materialization
    (Eq. 2's C_E(τ*) + C_W against the wall clock) or a cached read
    (C_R against the wall clock).  Costs are in the model's arbitrary
    time units; ``measured_seconds`` is wall time — the per-kind ratio
    of the two sums is the model's implied unit scale, and the spread
    of per-sample ratios around it is its (in)accuracy."""

    kind: str                      # "materialize" | "cached_read"
    key: str                       # strict fingerprint hex (short)
    predicted_cost: float
    measured_seconds: float
    predicted_bytes: int = 0
    measured_bytes: int = 0
    predicted_rows: int = 0
    measured_rows: int = 0

    def as_dict(self) -> dict:
        return {
            "kind": self.kind, "key": self.key,
            "predicted_cost": self.predicted_cost,
            "measured_seconds": self.measured_seconds,
            "predicted_bytes": self.predicted_bytes,
            "measured_bytes": self.measured_bytes,
            "predicted_rows": self.predicted_rows,
            "measured_rows": self.measured_rows,
        }


@dataclass
class CalibrationLog:
    """Accumulates :class:`CalibrationSample`\\ s and aggregates them
    into the ``CostModel.calibration()`` report: per kind, the implied
    cost-unit-per-second scale and mean absolute relative errors of the
    byte/row predictions.  Bounded: keeps the most recent
    ``max_samples`` raw samples (aggregates cover everything seen)."""

    max_samples: int = 1024
    samples: List[CalibrationSample] = field(default_factory=list)
    _agg: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def record(self, sample: CalibrationSample) -> None:
        self.samples.append(sample)
        if len(self.samples) > self.max_samples:
            del self.samples[: len(self.samples) - self.max_samples]
        a = self._agg.setdefault(sample.kind, {
            "n": 0, "predicted_cost": 0.0, "measured_seconds": 0.0,
            "predicted_bytes": 0, "measured_bytes": 0,
            "abs_rel_err_bytes": 0.0, "abs_rel_err_rows": 0.0,
        })
        a["n"] += 1
        a["predicted_cost"] += sample.predicted_cost
        a["measured_seconds"] += sample.measured_seconds
        a["predicted_bytes"] += sample.predicted_bytes
        a["measured_bytes"] += sample.measured_bytes
        if sample.measured_bytes > 0:
            a["abs_rel_err_bytes"] += abs(
                sample.predicted_bytes - sample.measured_bytes
            ) / sample.measured_bytes
        if sample.measured_rows > 0:
            a["abs_rel_err_rows"] += abs(
                sample.predicted_rows - sample.measured_rows
            ) / sample.measured_rows

    def report(self) -> dict:
        kinds = {}
        for kind, a in sorted(self._agg.items()):
            n = max(int(a["n"]), 1)
            kinds[kind] = {
                "n": int(a["n"]),
                "predicted_cost": a["predicted_cost"],
                "measured_seconds": a["measured_seconds"],
                "cost_units_per_second": (
                    a["predicted_cost"] / a["measured_seconds"]
                    if a["measured_seconds"] > 0 else None),
                "predicted_bytes": int(a["predicted_bytes"]),
                "measured_bytes": int(a["measured_bytes"]),
                "bytes_mean_abs_rel_err": a["abs_rel_err_bytes"] / n,
                "rows_mean_abs_rel_err": a["abs_rel_err_rows"] / n,
            }
        return {
            "n_samples": sum(k["n"] for k in kinds.values()),
            "kinds": kinds,
            "samples": [s.as_dict() for s in self.samples],
        }


def model_calibration(model) -> dict:
    """``calibration()`` for any model: the attached log's report, or
    an empty report when no log was ever attached."""
    log: Optional[CalibrationLog] = getattr(model, "calibration_log",
                                            None)
    return (log or CalibrationLog()).report()


def price_ce(ce: CoveringExpression, model: CostModel) -> CoveringExpression:
    """Fill ``value`` / ``weight`` of a CE in-place (returns it too)."""
    unshared = sum(model.execution_cost(o.node) for o in ce.se.occurrences)
    exec_ce = model.execution_cost(ce.tree)
    write_c = model.write_cost(ce.tree)
    read_c = model.read_cost(ce.tree)
    extraction = getattr(model, "extraction_cost", None)
    if extraction is not None:
        extract_c = sum(extraction(ce.tree, o.node)
                        for o in ce.se.occurrences)
    else:
        extract_c = 0.0
    total_ce = exec_ce + write_c + ce.m * read_c + extract_c
    ce.value = unshared - total_ce
    ce.weight = int(model.output_bytes(ce.tree))
    ce.est_rows = int(model.output_rows(ce.tree))
    ce.cost_detail = {
        "C_omega": unshared,
        "C_E_star": exec_ce,
        "C_W": write_c,
        "C_R": read_c,
        "C_X": extract_c,
        "m": ce.m,
        "C_Omega": total_ce,
    }
    return ce


def price_ces(ces: Sequence[CoveringExpression], model: CostModel):
    for ce in ces:
        price_ce(ce, model)
    return list(ces)


def price_resident_ce(ce: CoveringExpression) -> CoveringExpression:
    """Eq. 2 for an already-materialized CE (cross-batch retention):
    C_E(τ*) and C_W are sunk costs paid by the batch that admitted it,
    so the remaining price is m reads plus per-consumer extraction, and
    the knapsack weight is zero — the bytes already sit inside the
    memory manager's accounting.  Must run after :func:`price_ce` (it
    consumes the cost_detail breakdown)."""
    d = ce.cost_detail
    remaining = ce.m * d.get("C_R", 0.0) + d.get("C_X", 0.0)
    ce.value = d.get("C_omega", ce.value) - remaining
    ce.weight = 0
    ce.cost_detail = {**d, "resident": True, "C_Omega": remaining}
    return ce

"""Seeded draws of the engine's property suites, on any device.

The port's CPU suites (``test_torch_fuse.py``, ``test_torch_memory.py``,
``test_torch_mqo_end2end.py``, ``test_torch_resilience.py``,
``test_torch_partition.py``) and ``chip_smoke.py``'s phase P draw
their tables, plans and fault schedules from here, so the card is held
to the same cases as the CPU.  Every builder takes the device its
session or context runs on.  Imports only ``repro_torch``, numpy and
torch (``chip_smoke.py`` puts ``tests/`` on ``sys.path`` for it).
"""
import dataclasses

import numpy as np

from repro_torch.core.faults import FaultConfig
from repro_torch.relational import (F32, I32, STR, ExecContext,
                                    ExecutionConfig, MemoryConfig,
                                    Partitioning, Schema, Session,
                                    SessionConfig, expr as E, logical as L,
                                    make_storage)
from repro_torch.relational.datagen import generate_columns, synthetic_schema
from repro_torch.relational.stats import (RelationalCostModel, StatsRegistry,
                                          build_table_stats)


def assert_tables_bit_identical(a, b):
    assert a.schema.names == b.schema.names
    assert a.nrows == b.nrows
    an, bn = a.to_numpy(), b.to_numpy()
    for name in a.schema.names:
        np.testing.assert_array_equal(an[name], bn[name], err_msg=name)


# ---------------------------------------------------------------------------
# fused = eager, batched = per-query (test_torch_fuse.py)
# ---------------------------------------------------------------------------
FUSE_SCHEMA = Schema.of(("k", I32), ("v", I32), ("x", F32), ("s", STR(8)))


def toy(nrows=700, seed=0, fmt="columnar"):
    rng = np.random.default_rng(seed)
    cols = {
        "k": rng.integers(0, 20, nrows).astype(np.int32),
        "v": rng.integers(0, 1000, nrows).astype(np.int32),
        "x": rng.random(nrows).astype(np.float32),
        "s": rng.integers(97, 100, (nrows, 8)).astype(np.uint8),
    }
    st, _ = make_storage("t", FUSE_SCHEMA, nrows, fmt, cols=cols)
    return st, cols


def cost_model(cols, nrows):
    reg = StatsRegistry()
    reg.register("t", build_table_stats(cols, nrows, FUSE_SCHEMA))
    return RelationalCostModel(reg)


def _pick_op(rng, ops):
    return str(rng.choice(ops))


def random_pred(rng, avail) -> E.Expr:
    """Random predicate over the columns still in scope."""
    numeric = [c for c in ("k", "v", "x") if c in avail]

    def term():
        col = str(rng.choice(numeric))
        if col == "k":
            return E.cmp("k", _pick_op(rng, ["<", "<=", ">", ">=", "==",
                                             "!="]), int(rng.integers(0, 20)))
        if col == "v":
            return E.cmp("v", _pick_op(rng, ["<", ">", ">=", "<="]),
                         int(rng.integers(0, 1000)))
        return E.cmp("x", _pick_op(rng, ["<", ">"]),
                     float(np.float32(rng.random())))

    terms = [term() for _ in range(int(rng.integers(1, 4)))]
    if "k" in avail and "v" in avail and rng.integers(0, 3) == 0:
        terms.append(E.col_cmp("k", _pick_op(rng, ["<", ">"]), "v"))
    combine = E.and_ if rng.integers(0, 2) else E.or_
    pred = combine(*terms)
    if rng.integers(0, 4) == 0:
        pred = E.not_(pred)
    return pred


def random_chain(rng, fmt) -> L.Node:
    plan: L.Node = L.scan("t", FUSE_SCHEMA, fmt)
    n_ops = int(rng.integers(1, 5))
    saw_filter = False
    for i in range(n_ops):
        avail = set(plan.schema.names)
        can_filter = avail & {"k", "v", "x"}
        if can_filter and (rng.integers(0, 2) or not saw_filter):
            plan = plan.filter(random_pred(rng, avail))
            saw_filter = True
        else:
            names = list(plan.schema.names)
            keep = sorted(rng.choice(len(names),
                                     size=int(rng.integers(1, len(names) + 1)),
                                     replace=False))
            plan = plan.project(*[names[i] for i in keep])
    # chains that ended up projection-only stay valid test cases: the
    # fusion pass must leave them alone and results must still match
    return plan


def chain_draws(fmt, pallas):
    """``TestFusedEqualsEager.test_randomized_chains``'s cases:
    (storage, its columns, plan)."""
    n_cases = 6 if pallas else 12   # interpret mode is slow on CPU
    for case in range(n_cases):
        rng = np.random.default_rng(1000 * pallas + 10 * case
                                    + (fmt == "csv"))
        nrows = int(rng.integers(3, 1200))
        st, cols = toy(nrows=nrows, seed=case, fmt=fmt)
        yield st, cols, random_chain(rng, fmt)


def deferred_draws(fmt):
    """``test_deferred_sync_with_estimates``'s cases: (storage, cost
    model, plan)."""
    for case in range(6):
        rng = np.random.default_rng(77 + case)
        st, cols = toy(nrows=900, seed=case, fmt=fmt)
        yield st, cost_model(cols, 900), random_chain(rng, fmt)


def overflow_cases():
    """The two deferred-sync cases whose estimate undershoots (stats of
    all-zero columns: selectivity of v > 10 ~ 0 while ~99% of rows
    match), so the capacity overflows and the operator recompacts:
    (storage, cost model, plan, compare rows as multisets)."""
    st, cols = toy(nrows=800, seed=3)
    lying = {n: np.zeros_like(a) for n, a in cols.items()}
    yield (st, cost_model(lying, 800),
           L.scan("t", FUSE_SCHEMA, "columnar")
           .filter(E.cmp("v", ">", 10)).project("k", "v"), False)
    st, cols = toy(nrows=800, seed=4)
    lying = {n: np.zeros_like(a) for n, a in cols.items()}
    yield (st, cost_model(lying, 800),
           L.scan("t", FUSE_SCHEMA, "columnar")
           .filter(E.cmp("v", ">", 10))
           .groupby("k").agg(("n", "count", ""), ("sv", "sum", "v")), True)


def union_plan(rng) -> L.Node:
    left = (L.scan("t", FUSE_SCHEMA, "columnar")
            .filter(random_pred(rng, {"k", "v", "x"}))
            .project("k", "v"))
    right = (L.scan("t", FUSE_SCHEMA, "columnar")
             .filter(random_pred(rng, {"k", "v", "x"}))
             .project("k", "v"))
    plan = left.union(right)
    if rng.integers(0, 2):
        third = (L.scan("t", FUSE_SCHEMA, "columnar")
                 .filter(random_pred(rng, {"k", "v", "x"}))
                 .project("k", "v"))
        plan = plan.union(third)
    return plan


def union_draws():
    """``TestUnionDeferred.test_randomized_unions_match_eager``'s cases:
    (storage, cost model, plan)."""
    for case in range(8):
        rng = np.random.default_rng(500 + case)
        nrows = int(rng.integers(3, 1200))
        st, cols = toy(nrows=nrows, seed=case)
        yield st, cost_model(cols, nrows), union_plan(rng)


def eager_ctx(st, device):
    """The seed eager executor's context over table ``t``."""
    return ExecContext(catalog={"t": st}, device=device, fuse=False,
                       defer_sync=False)


def window_sessions(fmt, pallas, device):
    """``TestWindowBatchIdentity``'s (batched, per-query) sessions."""
    out = []
    for window_batch in (True, False):
        sess = Session.from_config(SessionConfig().with_execution(
            window_batch=window_batch, use_pallas_filter=pallas),
            device=device)
        for name, seed in (("t", 21), ("r", 22)):
            rng = np.random.default_rng(seed)
            nrows = 800 if name == "t" else 500
            cols = {
                "k": rng.integers(0, 20, nrows).astype(np.int32),
                "v": rng.integers(0, 1000, nrows).astype(np.int32),
                "x": rng.random(nrows).astype(np.float32),
                "s": rng.integers(97, 100, (nrows, 8)).astype(np.uint8),
            }
            st, _ = make_storage(name, FUSE_SCHEMA, nrows, fmt, cols=cols)
            sess.register(st, columnar_for_stats=cols)
        out.append(sess)
    return out


def mixed_window(sess, w):
    """4 same-template plans over t (batchable), one different
    shape over t, one over r — the batch group must contain exactly
    the template members and leave the rest per-query."""
    t = lambda: sess.table("t")
    qs = [t().filter(E.and_(E.cmp("v", ">", 100 + 37 * i + 11 * w),
                            E.cmp("v", "<", 950 - 13 * i)))
          .project("k", "v") for i in range(4)]
    qs.append(t().filter(E.cmp("x", "<", 0.5 + 0.01 * w))
              .project("k", "x"))
    qs.append(sess.table("r").filter(E.cmp("k", "==", 3 + w))
              .project("k", "v"))
    return qs


# ---------------------------------------------------------------------------
# budgets never change results (test_torch_memory.py)
# ---------------------------------------------------------------------------
MEM_SCHEMA = Schema.of(("a", I32), ("b", I32), ("c", I32))


def memory_session(budget, device, policy="lru", nrows=4000,
                   fmt="columnar", seed=7, **kw) -> Session:
    rng = np.random.default_rng(seed)
    cols = {c: rng.integers(0, 100, nrows).astype(np.int32)
            for c in ("a", "b", "c")}
    sess = Session.from_config(SessionConfig.from_legacy_kwargs(
        budget_bytes=budget, policy=policy, **kw), device=device)
    st, _ = make_storage("t", MEM_SCHEMA, nrows, fmt, cols=cols)
    sess.register(st, columnar_for_stats=cols)
    return sess


def shared_batch(sess: Session):
    t = sess.table("t")
    q = lambda: t.filter(E.cmp("a", ">", 40)).project("a", "b")
    r = lambda: t.filter(E.cmp("b", "<", 70)).project("b", "c")
    return [q(), q(), r(), r(), q()]


# ---------------------------------------------------------------------------
# MQO never changes results (test_torch_mqo_end2end.py)
# ---------------------------------------------------------------------------
FUZZ_COLS = ["c0", "c1", "c2"]
FUZZ_OPS = ["<", "<=", ">", ">=", "==", "!="]
FUZZ_SCHEMA = Schema.of(("c0", I32), ("c1", I32), ("c2", I32),
                        ("c3", I32))
DIM_SCHEMA = Schema.of(("d0", I32), ("d1", I32))


def fuzz_catalog():
    """The fuzz session's two tables: name -> (schema, rows, columns)."""
    rng = np.random.default_rng(42)
    n, nd = 800, 64
    fact = {c: rng.integers(0, 64, n).astype(np.int32) for c in
            ["c0", "c1", "c2", "c3"]}
    dim = {"d0": np.arange(nd, dtype=np.int32),
           "d1": rng.integers(0, 64, nd).astype(np.int32)}
    return {"ft": (FUZZ_SCHEMA, n, fact), "dim": (DIM_SCHEMA, nd, dim)}


def fuzz_session(device) -> Session:
    sess = Session.from_config(
        SessionConfig.from_legacy_kwargs(budget_bytes=1 << 24),
        device=device)
    for name, (schema, n, cols) in fuzz_catalog().items():
        st, _ = make_storage(name, schema, n, "columnar", cols=cols)
        sess.register(st)
    return sess


def fuzz_pred(rng, depth=0) -> E.Expr:
    """A seeded draw from the hypothesis ``_pred`` strategy's space."""
    kinds = ["cmp", "cmp", "cmp", "and", "or"] if depth < 2 else ["cmp"]
    kind = kinds[int(rng.integers(len(kinds)))]
    if kind == "cmp":
        return E.cmp(FUZZ_COLS[int(rng.integers(3))],
                     FUZZ_OPS[int(rng.integers(6))],
                     int(rng.integers(0, 61)))
    parts = [fuzz_pred(rng, depth + 1)
             for _ in range(int(rng.integers(2, 4)))]
    return (E.and_ if kind == "and" else E.or_)(*parts)


def fuzz_query(rng) -> L.Node:
    """A seeded draw from the hypothesis ``_query`` strategy's space."""
    q = L.scan("ft", FUZZ_SCHEMA).filter(fuzz_pred(rng))
    if rng.integers(0, 2):
        pool = FUZZ_COLS + ["c3"]
        cols = [pool[i] for i in rng.choice(
            4, size=int(rng.integers(1, 5)), replace=False)]
        q = q.project(*cols)
    shape = ["plain", "plain", "agg", "sort", "join"][int(rng.integers(5))]
    if shape == "agg" and q.schema.has("c0"):
        aggs = [("n", "count", "")]
        if q.schema.has("c3"):
            aggs.append(("s3", "sum", "c3"))
        q = q.groupby("c0").agg(*aggs)
    elif shape == "sort" and q.schema.has("c1"):
        q = q.sort("c1", desc=bool(rng.integers(0, 2)))
    elif shape == "join" and q.schema.has("c0"):
        other = L.scan("dim", DIM_SCHEMA).filter(
            E.cmp("d1", [">", "<"][int(rng.integers(2))],
                  int(rng.integers(0, 61))))
        q = q.join(other, "c0", "d0")
    return q


def fuzz_batches(seed, n):
    """``n`` seeded batches of 2-5 fuzz queries, each with its MCKP
    budget's log2 (10-24), as ``TestPropertyMQONeverChangesResults``
    draws them."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        queries = [fuzz_query(rng) for _ in range(int(rng.integers(2, 6)))]
        yield queries, int(rng.integers(10, 25))


def batch_decisions(res, strict_fp):
    """The MQO decisions of one ``run_batch`` result: the optimizer's
    report (SEs identified, CEs priced, MCKP items, the choice's count,
    value and weight; its seconds left out), every selected CE (SE psi,
    strict key, consumers, value, weight, estimated rows, admitted
    partitions) and the rewritten plans' strict fingerprints."""
    if res.mqo is None:
        return None
    rep = {k: v for k, v in dataclasses.asdict(res.mqo.report).items()
           if k not in ("optimize_seconds", "details")}
    ces = [(ce.psi.hex(), ce.strict_psi().hex(), ce.se.m, ce.value,
            ce.weight, ce.est_rows, ce.admitted_partitions)
           for ce in res.mqo.rewritten.ces]
    plans = [strict_fp(p).hex() for p in res.mqo.rewritten.plans]
    return rep, ces, plans


# ---------------------------------------------------------------------------
# fault injection (test_torch_resilience.py)
# ---------------------------------------------------------------------------
RES_SCHEMA = Schema.of(("a", I32), ("b", I32), ("c", I32))
RES_NROWS = 2000


def res_session(device, budget=1 << 24, *, config=None) -> Session:
    rng = np.random.default_rng(9)
    cols = {c: rng.integers(0, 100, RES_NROWS).astype(np.int32)
            for c in ("a", "b", "c")}
    if config is None:
        config = SessionConfig(memory=MemoryConfig(budget_bytes=budget))
    sess = Session.from_config(config, device=device)
    st, _ = make_storage("t", RES_SCHEMA, RES_NROWS, "columnar", cols=cols)
    sess.register(st)
    return sess


def res_cfg(budget=1 << 24, **fault_kw) -> SessionConfig:
    return SessionConfig(
        memory=MemoryConfig(budget_bytes=budget)
    ).with_faults(FaultConfig(**fault_kw))


def res_queries(sess):
    """Fixed 6-template pool: overlapping predicates so windows form
    CEs; a FIXED pool keeps the jit cache warm across soak windows."""
    t = lambda: sess.table("t")  # noqa: E731
    return [
        t().filter(E.cmp("a", ">", 50)).project("a", "b"),
        t().filter(E.and_(E.cmp("a", ">", 50), E.cmp("b", "<", 40)))
           .project("a", "b"),
        t().filter(E.and_(E.cmp("a", ">", 50), E.cmp("c", ">", 20)))
           .project("a", "c"),
        t().filter(E.cmp("b", "<", 70)).project("b", "c"),
        t().filter(E.and_(E.cmp("b", "<", 70), E.cmp("c", ">", 10)))
           .project("b", "c"),
        t().filter(E.cmp("c", ">", 35)).project("a", "b", "c"),
    ]


def batched_template(sess):
    # three same-SHAPE plans so the window forms one batch group
    t = lambda: sess.table("t")  # noqa: E731
    return [t().filter(E.and_(E.cmp("a", ">", 20 + 10 * i),
                              E.cmp("a", "<", 95 - 5 * i)))
            .project("a", "b") for i in range(3)]


PID_SCHEMA = Schema.of(("a", I32), ("b", I32), ("c", I32))


def pid_session(device, config=None) -> Session:
    # b == 777 is CORRELATED with the range-partition key a (only
    # rows with a < 130 carry it), so per-partition min/max stats
    # on b cannot refute the value anywhere — only the recorded
    # presence bitset prunes the other partitions
    rng = np.random.default_rng(13)
    a = rng.integers(0, 1000, 4000).astype(np.int32)
    b = np.where(a < 130, 777,
                 rng.integers(0, 1000, 4000)).astype(np.int32)
    c = rng.integers(0, 100, 4000).astype(np.int32)
    cols = {"a": a, "b": b, "c": c}
    if config is None:
        config = SessionConfig(memory=MemoryConfig(
            budget_bytes=1 << 24))
    sess = Session.from_config(config, device=device)
    st, _ = make_storage("p", PID_SCHEMA, 4000, "columnar", cols=cols)
    sess.register(st, columnar_for_stats=cols,
                  partitioning=Partitioning("a", "range", 8))
    return sess


def seed_then_probe(sess):
    t = lambda: sess.table("p")  # noqa: E731
    seed = t().filter(E.cmp("b", "==", 777)).project("a", "b", "c")
    probe = t().filter(E.and_(E.cmp("b", "==", 777),
                              E.cmp("c", ">", 10))).project("a", "b")
    s = sess.run_batch([seed], mqo=False)
    p = sess.run_batch([probe], mqo=False)
    return s, p


# ---------------------------------------------------------------------------
# pruned = unpruned (test_torch_partition.py)
# ---------------------------------------------------------------------------
PART_SCHEMA = synthetic_schema(n_int=3, n_dbl=2, n_str=1)
PART_NROWS = 8000
PART_COLS = generate_columns(PART_SCHEMA, PART_NROWS, seed=11)


def part_session(device, fmt="columnar", partitioning=None, prune=True,
                 budget=1 << 26, nrows=PART_NROWS, cols=None, name="t",
                 disk_latency=0.0):
    cols = PART_COLS if cols is None else cols
    sess = Session.from_config(SessionConfig(
        execution=ExecutionConfig(prune=prune),
        memory=MemoryConfig(budget_bytes=budget)), device=device)
    sess.disk_latency_per_byte = disk_latency
    st, _ = make_storage(name, PART_SCHEMA, nrows, fmt, cols=cols)
    sess.register(st, columnar_for_stats=cols, partitioning=partitioning)
    return sess


def make_pred(col, op, frac):
    """One comparison leaf from a (column, op, fraction) triple —
    shared by the hypothesis strategy and the seeded generator."""
    if col.startswith("d"):
        return E.cmp(col, op, float(np.float32(frac)))
    hi = {"n1": 1000, "n2": 10_000, "n3": 100_000}[col]
    # mix integral and fractional thresholds (fold_int_cmp path)
    v = frac * hi
    return E.cmp(col, op, float(v) if frac < 0.5 else int(v))


PRED_COLS = ["n1", "n2", "n3", "d1", "d2"]
PRED_OPS = ["<", "<=", ">", ">=", "==", "!="]


def random_pred_tree(rng: np.random.Generator, depth: int = 2):
    """Seeded random predicate tree over the same space the hypothesis
    strategy draws from (always-run fallback when hypothesis is not
    installed)."""
    kind = rng.integers(0, 4) if depth > 0 else 3
    if kind == 3:
        return make_pred(PRED_COLS[rng.integers(len(PRED_COLS))],
                         PRED_OPS[rng.integers(len(PRED_OPS))],
                         float(rng.random()))
    parts = [random_pred_tree(rng, depth - 1)
             for _ in range(int(rng.integers(2, 4)))]
    if kind == 0:
        return E.and_(*parts)
    if kind == 1:
        return E.or_(*parts)
    return E.not_(parts[0])


def pruned_query(sess, pred):
    return sess.table("t").filter(pred).project("n1", "n2", "d1")

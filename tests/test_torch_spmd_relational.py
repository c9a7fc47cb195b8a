"""The port's row-sharded relational route against the JAX package and
against its own single-device run.

One controller: one process holds the Session and places each scan's
rows over a mesh of 8 ``cpu`` positions (``NamedSharding(mesh,
("data",))``); each shard's mask comes from the filter wrappers (their
plain versions on CPU tensors) and each CSV shard is decoded on its own.
The JAX package's sharded tests (``tests/test_spmd.py::
TestShardedRelational``, ``tests/test_partition.py::
TestShardedPartitionedScan``) run here on their own inputs against the
JAX package's single-device results, exactly.  Sharded and single-
device port sessions must agree bitwise (padding rows included), make
the same MQO decisions and hold the same global pool bytes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.relational as R  # noqa: E402
import repro_torch.relational as T  # noqa: E402
from repro.relational.datagen import (generate_columns,  # noqa: E402
                                      synthetic_schema)
from repro.relational.tpcds import generate_tpcds_catalog  # noqa: E402
from repro_torch.carry import storage_from_reference  # noqa: E402
from repro_torch.core.fingerprint import strict_fingerprint  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch.sharding import NamedSharding  # noqa: E402
from repro_torch.relational import physical  # noqa: E402
from repro_torch.relational.observe import mqo_decision  # noqa: E402
from repro_torch.relational.tpcds import tpcds_queries  # noqa: E402

CPU = torch.device("cpu")
N_SHARDS = 8


def _sharding(n=N_SHARDS):
    mesh = make_test_mesh((n,), ("data",), devices=["cpu"] * n)
    return NamedSharding(mesh, ("data",))


def _session(P, sharding=None, budget=1 << 24, **exec_kw):
    cfg = P.SessionConfig(
        execution=P.ExecutionConfig(sharding=sharding, **exec_kw),
        memory=P.MemoryConfig(budget_bytes=budget))
    if P is R:
        return R.Session.from_config(cfg)
    return T.Session.from_config(cfg, **({} if sharding else
                                         {"device": CPU}))


def _register(sess, P, schema, nrows, cols, fmt, partitioning=None):
    st, _ = R.make_storage("t", schema, nrows, fmt, cols=cols)
    if P is T:
        st = storage_from_reference(st)
    kw = {}
    if partitioning is not None:
        kw["partitioning"] = P.Partitioning(*partitioning)
    sess.register(st, columnar_for_stats=cols, **kw)
    return sess


def _equal_in_order(a, b, label):
    """Same live rows in the same order (f32 bitwise)."""
    assert a.nrows == b.nrows, (label, a.nrows, b.nrows)
    an, bn = a.to_numpy(), b.to_numpy()
    assert list(an) == list(bn), label
    for c in an:
        np.testing.assert_array_equal(np.asarray(an[c]), np.asarray(bn[c]),
                                      err_msg=f"{label}.{c}")


def _bitwise(a, b, label):
    """Port tables equal to the last padding byte."""
    assert a.nrows == b.nrows and a.capacity == b.capacity, label
    for c in a.columns:
        assert a.columns[c].dtype == b.columns[c].dtype, (label, c)
        assert torch.equal(a.columns[c], b.columns[c]), (label, c)


# ---------------------------------------------------------------------------
# the JAX package's sharded cases, on their own inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["columnar", "csv"])
def test_row_sharded_query_matches(fmt):
    """``TestShardedRelational``: two projections of ``t`` (4,096 rows,
    seed 0) under MQO on a row-sharded session equal the JAX package's
    single-device run and the port's, and the decisions agree."""
    schema = synthetic_schema(n_int=3, n_dbl=1, n_str=1)
    cols = generate_columns(schema, 4096, seed=0)

    def q(P, s):
        E = P.expr
        return [s.table("t").filter(E.cmp("n1", ">", 300)).project("n1",
                                                                   "n2"),
                s.table("t").filter(E.cmp("n2", ">", 1000)).project("n2"),
                s.table("t").filter(E.cmp("n1", ">", 800)).project("n1",
                                                                   "s1")]

    ref = _register(_session(R), R, schema, 4096, cols, fmt)
    plain = _register(_session(T), T, schema, 4096, cols, fmt)
    sharded = _register(_session(T, _sharding()), T, schema, 4096, cols,
                        fmt)
    r0 = ref.run_batch(q(R, ref), mqo=True)
    r1 = plain.run_batch(q(T, plain), mqo=True)
    r2 = sharded.run_batch(q(T, sharded), mqo=True)
    for i, (a, b, c) in enumerate(zip(r0.results, r1.results, r2.results)):
        assert a.table.row_multiset() == c.table.row_multiset()
        _equal_in_order(a.table, c.table, f"{fmt}/jax/q{i}")
        _bitwise(b.table, c.table, f"{fmt}/port/q{i}")
    # the same MQO decisions: rewritten plans and the CE selection
    assert [strict_fingerprint(r.plan) for r in r1.results] == \
        [strict_fingerprint(r.plan) for r in r2.results]
    assert r1.cache_report == r2.cache_report
    assert plain.memory.device_used == sharded.memory.device_used


@pytest.mark.parametrize("fmt", ["columnar", "csv"])
def test_sharded_pruned_matches_single_device_unpruned(fmt):
    """``TestShardedPartitionedScan``: ``t`` (8,192 rows, seed 3) range-
    partitioned 8 ways on n1; the sharded, pruned port session equals the
    JAX package's single-device unpruned run exactly, and MQO work
    sharing on it matches."""
    schema = synthetic_schema(n_int=3, n_dbl=1, n_str=1)
    cols = generate_columns(schema, 8192, seed=3)
    part = ("n1", "range", 8)
    ref = _register(_session(R, budget=1 << 26, prune=False), R, schema,
                    8192, cols, fmt, part)
    plain = _register(_session(T, budget=1 << 26, prune=False), T, schema,
                      8192, cols, fmt, part)
    sharded = _register(_session(T, _sharding(), budget=1 << 26,
                                 prune=True), T, schema, 8192, cols, fmt,
                        part)

    def q(P, s, p):
        return s.table("t").filter(p).project("n1", "n2", "d1")

    def preds(E):
        return [E.cmp("n1", "<", 200),
                E.and_(E.cmp("n1", ">", 100), E.cmp("d1", "<", 0.5)),
                E.or_(E.cmp("n1", "<", 50), E.cmp("n1", ">", 900))]

    r0 = ref.run_batch([q(R, ref, p) for p in preds(R.expr)], mqo=False)
    r1 = plain.run_batch([q(T, plain, p) for p in preds(T.expr)],
                         mqo=False)
    r2 = sharded.run_batch([q(T, sharded, p) for p in preds(T.expr)],
                           mqo=False)
    for i, (a, b, c) in enumerate(zip(r0.results, r1.results, r2.results)):
        _equal_in_order(a.table, c.table, f"{fmt}/jax/q{i}")
        _equal_in_order(b.table, c.table, f"{fmt}/port/q{i}")
    fam = [q(T, sharded, T.expr.cmp("n1", "<", v)) for v in (300, 350, 400)]
    fam_ref = [q(R, ref, R.expr.cmp("n1", "<", v)) for v in (300, 350, 400)]
    rs = sharded.run_batch(fam, mqo=True)
    rr = ref.run_batch(fam_ref, mqo=False)
    for a, b in zip(rr.results, rs.results):
        assert a.table.row_multiset() == b.table.row_multiset()


def test_scan_placed_across_devices():
    """``TestShardedPartitionedScan::test_scan_placed_across_devices``:
    the scan pool holds each column split over all 8 positions, and the
    pool books count the global bytes."""
    schema = synthetic_schema(n_int=2, n_dbl=0, n_str=0)
    cols = generate_columns(schema, 4096, seed=5)
    s = _register(_session(T, _sharding(), budget=1 << 26), T, schema,
                  4096, cols, "columnar", ("n1", "range", 8))
    ctx = s._fresh_ctx()
    table = physical.execute(s.table("t").filter(
        T.expr.cmp("n1", ">", 0)).project("n1", "n2"), ctx)
    assert table.nrows > 0
    entries = [e.payload for e in ctx.scan_cache.entries.values()]
    assert entries, "scan cache empty"
    assert {len(c.shards) for c in entries
            if isinstance(c, physical.RowShards)} == {N_SHARDS}
    for e in ctx.scan_cache.entries.values():
        assert e.nbytes == e.payload.numel() * e.payload.element_size()
        assert e.nbytes == sum(x.numel() * x.element_size()
                               for x in e.payload.shards)


# ---------------------------------------------------------------------------
# the TPC-DS stream, sharded against single-device
# ---------------------------------------------------------------------------
def _stream(sess, passes=2):
    out = []
    for _ in range(passes):
        svc = sess.service(max_batch=8)
        handles = [svc.submit(q) for q in tpcds_queries(sess)]
        svc.flush()
        out.append(([h.result() for h in handles],
                    [mqo_decision(h, strict_fingerprint) for h in handles]))
    return out


@pytest.fixture(scope="module")
def tpcds_catalog():
    return generate_tpcds_catalog(5_000, 0)


@pytest.mark.parametrize("fmt", ["columnar", "csv"])
def test_tpcds_stream_sharded_equals_single_device(fmt, tpcds_catalog):
    """The 50 TPC-DS queries in windows of 8, cold then warm: every
    table bitwise equal, every MQO decision equal, the same pool bytes,
    and no degradation event on the sharded session."""
    runs, sessions = [], []
    for sharding in (None, _sharding()):
        s = _session(T, sharding, budget=1 << 26)
        for name, (schema, nrows, cols) in tpcds_catalog.items():
            st, _ = R.make_storage(name, schema, nrows, fmt, cols=cols)
            s.register(storage_from_reference(st), columnar_for_stats=cols)
        runs.append(_stream(s))
        sessions.append(s)
    for p, ((t1, d1), (t2, d2)) in enumerate(zip(*runs)):
        assert len(t1) == len(t2) == 50
        for i, (a, b) in enumerate(zip(t1, t2)):
            _bitwise(a, b, f"{fmt}/pass{p}/q{i}")
        assert d1 == d2, (fmt, p)
    plain, sharded = sessions
    assert plain.memory.device_used == sharded.memory.device_used
    assert sharded.telemetry().registry.value("events.total") == 0


# ---------------------------------------------------------------------------
# per-shard launches
# ---------------------------------------------------------------------------
def test_window_batch_launches_once_per_shard(monkeypatch):
    """A window-batched group of three literal variants launches the
    batch mask once per shard for the whole group; each CSV scan
    decodes once per shard."""
    from repro_torch.kernels.filter_project import ops

    calls = {"batch": [], "parse": 0}
    real_batch, real_parse = ops.filter_mask_batch, physical._parse_fields

    def spy_batch(cols, *a, **kw):
        calls["batch"].append((cols[0].shape[0], kw.get("block")))
        return real_batch(cols, *a, **kw)

    def spy_parse(raw, fields):
        calls["parse"] += 1
        return real_parse(raw, fields)

    monkeypatch.setattr(ops, "filter_mask_batch", spy_batch)
    monkeypatch.setattr(physical, "_parse_fields", spy_parse)
    schema = synthetic_schema(n_int=3, n_dbl=1, n_str=1)
    cols = generate_columns(schema, 4096, seed=0)
    s = _register(_session(T, _sharding()), T, schema, 4096, cols, "csv")
    E = T.expr
    qs = [s.table("t").filter(E.cmp("n1", "<", v)).project("n1", "n2")
          for v in (100, 200, 300)]
    r = s.run_batch(qs, mqo=False)
    assert r.metrics.batched_dispatches == 1
    assert len(calls["batch"]) == N_SHARDS
    assert {n for n, _ in calls["batch"]} == {4096 // N_SHARDS}
    sharded_parses, calls["parse"] = calls["parse"], 0
    plain = _register(_session(T), T, schema, 4096, cols, "csv")
    rp = plain.run_batch([plain.table("t").filter(E.cmp("n1", "<", v))
                          .project("n1", "n2") for v in (100, 200, 300)],
                         mqo=False)
    # each member's scan decodes once a shard where it decodes once
    assert calls["parse"] == 3 and sharded_parses == 3 * N_SHARDS
    for i, (a, b) in enumerate(zip(rp.results, r.results)):
        _bitwise(a.table, b.table, f"batch/q{i}")


@pytest.mark.parametrize("nrows", [4097, 5000, 1021])
def test_sharded_mask_matches_plain_on_odd_rows(nrows):
    """Odd row counts: shards past the last live row hold none (4097
    rows over 8 shards of 1024 leave the last three empty) and the
    literal and torch-expression routes agree with the slotted one."""
    schema = synthetic_schema(n_int=3, n_dbl=1, n_str=1)
    cols = generate_columns(schema, nrows, seed=7)
    E = T.expr
    preds = [E.cmp("n1", ">", 500),
             E.and_(E.cmp("n2", "<", 700), E.cmp("d1", ">", 0.25)),
             E.cmp("s1", "==", b"a")]
    for exec_kw in ({}, {"shape_cache": False, "use_pallas_filter": True},
                    {"shape_cache": False}):
        plain = _register(_session(T, **exec_kw), T, schema, nrows, cols,
                          "columnar")
        sharded = _register(_session(T, _sharding(), **exec_kw), T, schema,
                            nrows, cols, "columnar")
        for i, p in enumerate(preds):
            a = plain.run_batch([plain.table("t").filter(p).project(
                "n1", "d1")], mqo=False).results[0].table
            b = sharded.run_batch([sharded.table("t").filter(p).project(
                "n1", "d1")], mqo=False).results[0].table
            _bitwise(a, b, f"{nrows}/{exec_kw}/p{i}")


def test_indivisible_capacity_takes_single_device_path():
    """Three shards do not divide a power-of-two capacity: the scans are
    placed whole on the first device, as ``jax.device_put`` falls back
    to one placement, and the results equal the single-device run."""
    schema = synthetic_schema(n_int=2, n_dbl=1, n_str=0)
    cols = generate_columns(schema, 3000, seed=1)
    s = _register(_session(T, _sharding(3)), T, schema, 3000, cols,
                  "columnar")
    plain = _register(_session(T), T, schema, 3000, cols, "columnar")
    q = lambda x: [x.table("t").filter(T.expr.cmp("n1", "<", 400))  # noqa
                   .project("n1", "d1")]
    a = plain.run_batch(q(plain), mqo=False).results[0].table
    b = s.run_batch(q(s), mqo=False).results[0].table
    _bitwise(a, b, "indivisible")
    assert not any(isinstance(e.payload, physical.RowShards)
                   for e in s._scan_pool.entries.values())


def test_sync_and_async_fronts_agree_on_a_sharded_session():
    """``QueryService`` and ``AsyncQueryService`` over row-sharded
    sessions return the same tables as the single-device sync front."""
    import asyncio

    schema = synthetic_schema(n_int=3, n_dbl=1, n_str=1)
    cols = generate_columns(schema, 4096, seed=2)
    E = T.expr

    def queries(s):
        return [s.table("t").filter(E.cmp("n1", "<", v)).project("n1", "d1")
                for v in (100, 250, 400, 900)] + \
               [s.table("t").filter(E.cmp("n2", ">", 500)).project("n2")]

    plain = _register(_session(T), T, schema, 4096, cols, "columnar")
    svc = plain.service(max_batch=5)
    want = [svc.submit(q) for q in queries(plain)]
    svc.flush()
    want = [h.result() for h in want]

    sync_s = _register(_session(T, _sharding()), T, schema, 4096, cols,
                       "columnar")
    svc = sync_s.service(max_batch=5)
    got = [svc.submit(q) for q in queries(sync_s)]
    svc.flush()
    for i, (a, h) in enumerate(zip(want, got)):
        _bitwise(a, h.result(), f"sync/q{i}")

    async_s = _register(_session(T, _sharding()), T, schema, 4096, cols,
                        "columnar")

    async def run():
        from repro_torch.relational.async_service import (AsyncConfig,
                                                          AsyncQueryService)
        async with AsyncQueryService(
                async_s, config=AsyncConfig(max_batch=5)) as asvc:
            handles = [await asvc.submit(q) for q in queries(async_s)]
            return await asyncio.gather(*handles)

    for i, (a, b) in enumerate(zip(want, asyncio.run(run()))):
        _bitwise(a, b, f"async/q{i}")

"""The port's async serving front (``relational/async_service.py``).

The properties the JAX package's ``tests/test_async_service.py`` holds
its front to, held here on the port with ``device="cpu"``:
  * submit/await round trips and async-vs-sync bit-identity on the
    same plan set (both fronts route through QueryService._run_window);
  * the background closer: deadline windows close with no caller in
    flight, and ``result()`` on an already-done sync handle drives the
    deadline clock for other windows;
  * per-tenant admission control: fail-fast and queue-mode quotas,
    byte attribution on the memory pools, per-tenant report sections;
  * adaptive windowing on an injectable clock: bursty vs trickle
    arrivals move the window parameters in the right direction, and the
    p99 SLO bounds wait + execution;
  * labelled metric series;
  * the async_close fault point and the seeded soak over the
    ``FAULT_SEED`` matrix: every handle resolves, successes are
    bit-identical to a fault-free reference.
And one parity test: the JAX package's ``AsyncQueryService`` and the
port's serve the same plan set over the same CSV bytes on a fake clock,
with equal tables under the contract of ``torch_parity.py`` and equal
per-query and per-window MQO decisions.

Tests drive their own event loops via ``asyncio.run``.
"""
import asyncio
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.relational as R  # noqa: E402
import repro_torch.relational as T  # noqa: E402
from repro.core.fingerprint import strict_fingerprint as j_strict  # noqa
from repro.relational.tpcds import generate_tpcds_catalog  # noqa: E402
from repro_torch.core.faults import FAULT_POINTS, FaultConfig  # noqa: E402
from repro_torch.core.fingerprint import strict_fingerprint as t_strict
from repro_torch.core.telemetry import (MetricsRegistry,  # noqa: E402
                                        labeled_key)
from repro_torch.relational import (AdmissionError, AsyncConfig,  # noqa
                                    AdaptiveWindowPolicy,
                                    AsyncQueryService, I32, MemoryConfig,
                                    QueryError, QueryService, Relation,
                                    Schema, Session, SessionConfig,
                                    TenantQuota, expr as E, logical as L,
                                    make_storage)
from repro_torch.relational.observe import mqo_decision, mqo_trace  # noqa
from torch_parity import assert_parity, host, sessions  # noqa: E402

# the CI concurrency job sweeps this over a small matrix
FAULT_SEED = int(os.environ.get("FAULT_SEED", "0"))
CPU = torch.device("cpu")

S = Schema.of(("a", I32), ("b", I32), ("c", I32))
NROWS = 2000


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _mk_session(budget=1 << 24, *, config=None) -> Session:
    rng = np.random.default_rng(9)
    cols = {c: rng.integers(0, 100, NROWS).astype(np.int32)
            for c in ("a", "b", "c")}
    if config is None:
        config = SessionConfig(memory=MemoryConfig(budget_bytes=budget))
    sess = Session.from_config(config, device=CPU)
    st, _ = make_storage("t", S, NROWS, "columnar", cols=cols)
    sess.register(st)
    return sess


def _queries(sess):
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


def _tables_bit_identical(ta, tb):
    assert ta.nrows == tb.nrows
    assert ta.schema.names == tb.schema.names
    for n in ta.schema.names:
        assert torch.equal(ta.columns[n][: ta.nrows],
                           tb.columns[n][: tb.nrows]), n


def run(coro):
    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# submit / await round trips
# ---------------------------------------------------------------------------
class TestAsyncSubmission:
    def test_submit_await_matches_sync_reference(self):
        ref = _mk_session()
        base = ref.run_batch(_queries(ref)[:1])

        async def go():
            sess = _mk_session()
            async with AsyncQueryService(
                    sess, config=AsyncConfig(max_batch=1)) as svc:
                h = await svc.submit(_queries(sess)[0])
                t1 = await h
                t2 = await h.result()     # both await forms work
            return t1, t2

        t1, t2 = run(go())
        _tables_bit_identical(t1, base.results[0].table)
        _tables_bit_identical(t2, base.results[0].table)

    def test_concurrent_submitters_share_one_window(self):
        async def go():
            sess = _mk_session()
            qs = _queries(sess)
            async with AsyncQueryService(
                    sess, config=AsyncConfig(max_batch=6)) as svc:
                async def client(q):
                    h = await svc.submit(q)
                    return h, await h

                done = await asyncio.gather(*(client(q) for q in qs))
            sizes = [h.explain()["window_size"] for h, _ in done]
            closed = sess.telemetry().registry.value("windows.closed")
            return sizes, closed

        sizes, closed = run(go())
        assert sizes == [6] * 6          # one shared window
        assert closed == 1

    def test_async_vs_sync_bit_identical_on_same_plan_set(self):
        sync_sess = _mk_session()
        base = sync_sess.run_batch(_queries(sync_sess))

        async def go():
            sess = _mk_session()
            async with AsyncQueryService(
                    sess, config=AsyncConfig(max_batch=6)) as svc:
                hs = [await svc.submit(q) for q in _queries(sess)]
                return await asyncio.gather(*hs)

        tables = run(go())
        for t, r0 in zip(tables, base.results):
            _tables_bit_identical(t, r0.table)

    def test_failed_query_raises_on_await_sibling_completes(self):
        async def go():
            sess = _mk_session()
            async with AsyncQueryService(
                    sess, config=AsyncConfig(max_batch=2)) as svc:
                ghost = Relation(L.scan("ghost", S, "columnar"), sess)
                h_bad = await svc.submit(ghost)
                h_ok = await svc.submit(_queries(sess)[0])
                t = await h_ok
                with pytest.raises(Exception):
                    await h_bad
                assert h_bad.failed
                assert isinstance(h_bad.error, QueryError)
                assert not h_ok.failed
                return t

        assert run(go()).nrows > 0


def test_window_ends_with_a_device_synchronize(monkeypatch):
    """The worker waits for the session's device after each window,
    before any future of the window resolves."""
    from repro_torch.relational import async_service

    synced = []
    monkeypatch.setattr(async_service, "synchronize", synced.append)

    async def go():
        sess = _mk_session()
        async with AsyncQueryService(
                sess, config=AsyncConfig(max_batch=2)) as svc:
            hs = [await svc.submit(q) for q in _queries(sess)[:4]]
            first = await hs[0]
            seen = list(synced)
            await asyncio.gather(*hs)
        return sess, seen, first

    sess, seen, first = run(go())
    assert seen and seen[0] == sess.device
    assert synced == [sess.device] * 2      # one per window
    assert first.nrows > 0


# ---------------------------------------------------------------------------
# the background closer
# ---------------------------------------------------------------------------
class TestBackgroundCloser:
    def test_deadline_closes_with_no_caller_in_flight(self):
        """The retired caveat: nobody calls submit/poll/result — the
        closer task alone fires the deadline."""
        async def go():
            sess = _mk_session()
            async with AsyncQueryService(
                    sess,
                    config=AsyncConfig(max_batch=64,
                                       max_wait_s=0.05)) as svc:
                h = await svc.submit(_queries(sess)[0])
                # no flush, no poll: only the background closer can
                # resolve this within the timeout
                return await asyncio.wait_for(h.result(), timeout=10)

        assert run(go()).nrows > 0

    def test_flush_expired_and_poll_are_thin_shims(self):
        async def go():
            sess = _mk_session()
            async with AsyncQueryService(
                    sess,
                    config=AsyncConfig(max_batch=64,
                                       max_wait_s=30.0)) as svc:
                h = await svc.submit(_queries(sess)[0])
                assert svc.flush_expired() is None
                assert svc.poll() is False
                assert not h.done          # nothing closed the window
                await svc.flush()
                await svc.drain()
                assert h.done

        run(go())

    def test_sync_done_result_closes_other_expired_window(self):
        """Satellite fix on the SYNC front: ``result()`` on an
        already-resolved handle drives the cooperative deadline clock,
        so an expired window closes without an unrelated submit."""
        sess = _mk_session()
        clock = FakeClock()
        svc = QueryService(sess, max_batch=10, max_wait_s=1.0,
                           clock=clock)
        qs = _queries(sess)
        a = svc.submit(qs[0])
        svc.flush()
        assert a.done
        b = svc.submit(qs[1])              # opens a new deadline window
        clock.advance(2.0)                 # ... which expires
        a.result()                         # done handle still drives it
        assert b.done
        _tables_bit_identical(a.result(), a.result())


# ---------------------------------------------------------------------------
# admission control + tenants
# ---------------------------------------------------------------------------
class TestAdmissionControl:
    def test_inflight_quota_fail_fast(self):
        async def go():
            sess = _mk_session()
            cfg = AsyncConfig(
                max_batch=64, max_wait_s=30.0,
                quotas={"acme": TenantQuota(max_inflight=1,
                                            on_over="fail")})
            async with AsyncQueryService(sess, config=cfg) as svc:
                qs = _queries(sess)
                h = await svc.submit(qs[0], tenant="acme")
                with pytest.raises(AdmissionError):
                    await svc.submit(qs[1], tenant="acme")
                # other tenants (and untenanted work) are unaffected
                await svc.submit(qs[2], tenant="other")
                await svc.submit(qs[3])
                await svc.flush()
                await svc.drain()
                assert h.done
            reg = sess.telemetry().registry
            assert reg.value("admission.rejected",
                             labels={"tenant": "acme"}) == 1

        run(go())

    def test_inflight_quota_queue_mode_waits_then_admits(self):
        async def go():
            sess = _mk_session()
            cfg = AsyncConfig(
                max_batch=1,    # every submission closes its window
                quotas={"acme": TenantQuota(max_inflight=1,
                                            on_over="queue")})
            async with AsyncQueryService(sess, config=cfg) as svc:
                qs = _queries(sess)

                async def client(q):
                    h = await svc.submit(q, tenant="acme")
                    return await h

                tables = await asyncio.wait_for(
                    asyncio.gather(*(client(q) for q in qs[:3])),
                    timeout=30)
            reg = sess.telemetry().registry
            return tables, reg

        tables, reg = run(go())
        assert len(tables) == 3 and all(t.nrows >= 0 for t in tables)
        assert reg.value("admission.admitted",
                         labels={"tenant": "acme"}) == 3
        # at least one submission had to wait for an in-flight slot
        assert reg.value("admission.queued",
                         labels={"tenant": "acme"}) >= 1

    def test_byte_attribution_and_tenant_report(self):
        async def go():
            sess = _mk_session()
            async with AsyncQueryService(
                    sess, config=AsyncConfig(max_batch=2)) as svc:
                qs = _queries(sess)
                ha = [await svc.submit(q, tenant="acme")
                      for q in qs[:2]]
                hb = [await svc.submit(q, tenant="blue")
                      for q in qs[3:5]]
                await asyncio.gather(*(ha + hb))
                report = svc.metrics_report()
            usage = sess.memory.owner_usage()
            return report, usage

        report, usage = run(go())
        # execution stamped live pool bytes to the submitting tenants
        assert "acme" in usage and sum(usage["acme"].values()) > 0
        tenants = report["tenants"]
        for t in ("acme", "blue"):
            assert tenants[t]["queries.submitted"] == 2
            assert tenants[t]["queries.succeeded"] == 2
            assert tenants[t]["bytes_total"] > 0
            assert tenants[t]["latency"]["count"] == 2
        # labeled snapshot keys use the canonical rendered form
        snap = report["registry"]
        assert "queries.submitted{tenant=acme}" in snap["counters"]

    def test_bytes_quota_fail_fast_when_nothing_inflight(self):
        """Resident attributed bytes over max_bytes with zero in-flight
        queries can never be freed by a completion — queue mode must
        reject instead of deadlocking."""
        async def go():
            sess = _mk_session()
            cfg = AsyncConfig(
                max_batch=1,
                quotas={"acme": TenantQuota(max_bytes=1)})
            async with AsyncQueryService(sess, config=cfg) as svc:
                qs = _queries(sess)
                h = await svc.submit(qs[0], tenant="acme")
                await h                        # resident bytes now > 1
                assert sess.memory.owner_bytes("acme") > 1
                with pytest.raises(AdmissionError):
                    await svc.submit(qs[1], tenant="acme")

        run(go())


# ---------------------------------------------------------------------------
# adaptive windowing
# ---------------------------------------------------------------------------
def _policy(sess, clock, **cfg_kw):
    cfg = AsyncConfig(adaptive=True, slo_p99_s=0.5, min_batch=1,
                      max_batch_cap=64, exec_default_s=0.05, **cfg_kw)
    return AdaptiveWindowPolicy(sess, cfg, clock=clock)


class TestAdaptiveWindowing:
    def test_bursty_vs_trickle_directionality(self):
        """A bursty family earns a bigger batch target than a trickle
        family; the trickle degenerates to close-immediately."""
        sess = _mk_session()
        clock = FakeClock()
        pol = _policy(sess, clock)
        for _ in range(50):                  # 1 kHz burst
            clock.advance(0.001)
            pol.observe_arrival("burst", now=clock())
        for _ in range(10):                  # one every 2 s
            clock.advance(2.0)
            pol.observe_arrival("trickle", now=clock())
        burst = pol.decide("burst")
        trickle = pol.decide("trickle")
        assert burst.max_batch > trickle.max_batch
        assert burst.max_batch > 8           # real sharing harvested
        assert trickle.max_batch == 1        # latency-optimal
        assert burst.predicted_saving_s > trickle.predicted_saving_s

    def test_p99_slo_respected_on_injectable_clock(self):
        """wait + exec_p99 <= slo by construction, for any observed
        execution-time distribution."""
        sess = _mk_session()
        clock = FakeClock()
        pol = _policy(sess, clock)
        reg = sess.telemetry().registry
        for v in (0.01, 0.02, 0.05, 0.3):    # window exec observations
            reg.observe("window.seconds", v)
        for _ in range(50):
            clock.advance(0.001)
            pol.observe_arrival("burst", now=clock())
        p = pol.decide("burst")
        exec99 = reg.histogram("window.seconds").percentile(0.99)
        assert p.max_wait_s + exec99 <= 0.5 + 1e-9
        assert p.wait_budget_s == pytest.approx(
            max(0.0, 0.5 - exec99))

    def test_slo_already_blown_collapses_to_min_batch(self):
        sess = _mk_session()
        clock = FakeClock()
        pol = _policy(sess, clock)
        reg = sess.telemetry().registry
        reg.observe("window.seconds", 10.0)  # exec alone exceeds SLO
        for _ in range(50):
            clock.advance(0.001)
            pol.observe_arrival("burst", now=clock())
        p = pol.decide("burst")
        assert p.max_batch == 1
        assert p.max_wait_s == 0.0           # close immediately

    def test_fixed_mode_uses_configured_knobs(self):
        sess = _mk_session()
        cfg = AsyncConfig(adaptive=False, max_batch=7, max_wait_s=1.5)
        pol = AdaptiveWindowPolicy(sess, cfg, clock=FakeClock())
        p = pol.decide("any")
        assert (p.max_batch, p.max_wait_s) == (7, 1.5)

    def test_adaptive_end_to_end_records_metrics(self):
        async def go():
            sess = _mk_session()
            cfg = AsyncConfig(adaptive=True, slo_p99_s=5.0,
                              max_batch_cap=8, exec_default_s=0.01)
            async with AsyncQueryService(sess, config=cfg) as svc:
                qs = _queries(sess)
                for _ in range(3):
                    hs = [await svc.submit(q) for q in qs]
                    await asyncio.gather(*hs)
                    await svc.flush()
                    await svc.drain()
            reg = sess.telemetry().registry
            return reg

        reg = run(go())
        assert reg.histogram("window.adaptive.batch").count > 0
        assert reg.histogram("window.adaptive.wait_s").count > 0
        assert reg.ewma("window.adaptive.predicted_saving_s").n > 0
        assert reg.ewma("window.adaptive.realized_saving_s").n > 0


# ---------------------------------------------------------------------------
# labels (snapshot-format pin, satellite 2)
# ---------------------------------------------------------------------------
class TestMetricLabels:
    def test_labeled_key_rendering_is_pinned(self):
        assert labeled_key("queries.submitted") == "queries.submitted"
        assert labeled_key("queries.submitted", {"tenant": "acme"}) \
            == "queries.submitted{tenant=acme}"
        # label keys sort for a canonical rendering
        assert labeled_key("m", {"b": "2", "a": "1"}) == "m{a=1,b=2}"

    def test_registry_labeled_series(self):
        reg = MetricsRegistry()
        reg.inc("queries.submitted")
        reg.inc("queries.submitted", labels={"tenant": "acme"})
        reg.inc("queries.submitted", 2, labels={"tenant": "blue"})
        snap = reg.snapshot()
        assert snap["counters"]["queries.submitted"] == 1
        assert snap["counters"]["queries.submitted{tenant=acme}"] == 1
        assert snap["counters"]["queries.submitted{tenant=blue}"] == 2
        assert reg.value("queries.submitted",
                         labels={"tenant": "blue"}) == 2
        series = dict(
            (labels["tenant"], key)
            for labels, key in reg.series("queries.submitted"))
        assert series == {
            "acme": "queries.submitted{tenant=acme}",
            "blue": "queries.submitted{tenant=blue}",
        }
        # histograms and ewmas label identically
        reg.observe("latency.tenant", 0.5, labels={"tenant": "acme"})
        assert reg.histogram(
            "latency.tenant", labels={"tenant": "acme"}).count == 1


# ---------------------------------------------------------------------------
# async_close fault point + the async soak
# ---------------------------------------------------------------------------
def _fault_cfg(budget=1 << 24, **fault_kw) -> SessionConfig:
    return SessionConfig(
        memory=MemoryConfig(budget_bytes=budget)
    ).with_faults(FaultConfig(**fault_kw))


class TestAsyncCloseFault:
    def test_crashed_closer_restarts_and_handles_resolve(self):
        async def go():
            sess = _mk_session(config=_fault_cfg(
                seed=FAULT_SEED, schedule={"async_close": (0,)}))
            async with AsyncQueryService(
                    sess,
                    config=AsyncConfig(max_batch=64,
                                       max_wait_s=0.02)) as svc:
                h = await svc.submit(_queries(sess)[0])
                # first deadline pass fires the fault and crashes the
                # closer; the supervisor restarts it and the still-due
                # window closes on the next pass
                t = await asyncio.wait_for(h.result(), timeout=10)
                return t, svc.closer_restarts, sess

        t, restarts, sess = run(go())
        assert t.nrows > 0
        assert restarts >= 1
        reg = sess.telemetry().registry
        assert reg.value("async.closer_restarts") >= 1
        assert sess.fault_injector.invocations("async_close") >= 1

    def test_soak_with_faults_including_async_close(self):
        """The resilience soak property, extended to the async front: under
        seeded faults at every point INCLUDING async_close, every async
        handle resolves and every success is bit-identical to a
        fault-free reference of the same window."""
        rates = {p: 0.05 for p in FAULT_POINTS}
        rates["window_close"] = 0.02
        rates["async_close"] = 0.5     # exercise the closer hard

        async def go():
            faulty = _mk_session(config=_fault_cfg(
                1 << 15, seed=FAULT_SEED, rates=rates))
            ref = _mk_session(budget=1 << 15)
            import random
            rng = random.Random(FAULT_SEED)
            n_ok = n_failed = 0
            async with AsyncQueryService(
                    faulty,
                    config=AsyncConfig(max_batch=64,
                                       max_wait_s=0.01)) as svc:
                for w in range(25):
                    idxs = rng.choices(range(6), k=rng.randint(1, 3))
                    pool_f, pool_r = _queries(faulty), _queries(ref)
                    hs = [await svc.submit(pool_f[i]) for i in idxs]
                    # deadline-close only: every window exercises the
                    # async_close fault point
                    done = await asyncio.wait_for(
                        asyncio.gather(*(h.result() for h in hs),
                                       return_exceptions=True),
                        timeout=60)
                    base = ref.run_batch([pool_r[i] for i in idxs])
                    for h, t, r0 in zip(hs, done, base.results):
                        assert h.done, f"window {w}: unresolved handle"
                        if isinstance(t, BaseException):
                            n_failed += 1
                            assert h.failed
                        else:
                            n_ok += 1
                            _tables_bit_identical(t, r0.table)
                    violations = faulty.memory.audit()
                    assert violations == [], f"window {w}: {violations}"
            return n_ok, n_failed, svc, faulty

        n_ok, n_failed, svc, faulty = run(go())
        assert n_ok > 0, "soak never completed a query"
        inj = faulty.fault_injector
        assert inj.invocations("async_close") > 0
        # at rate 0.5 over 25 deadline windows the closer crashed at
        # least once for any realistic seed stream
        assert svc.closer_restarts >= 1


def test_async_windows_take_the_sync_fronts_decisions():
    """The check ``chip_smoke.py`` phase A0 makes on the card, on CSV
    tables on the CPU: the TPC-DS stream through the async front in
    count-closed windows gives the sync front's tables, per-query MQO
    decisions and per-window spans, cold and warm."""
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              tpcds_queries)

    def session():
        sess = build_tpcds_session(scale_rows=2_000, fmt="csv",
                                   device="cpu")
        sess.enable_tracing()
        return sess

    sync, asess = session(), session()
    cfg = AsyncConfig(max_batch=8, max_wait_s=3600.0)

    async def serve():
        async with AsyncQueryService(asess, config=cfg) as front:
            hs = [await front.submit(q) for q in tpcds_queries(asess)]
            await front.flush()
            return hs, await asyncio.gather(*hs)

    for _ in ("cold", "warm"):
        # one front per pass on each side, as chip_smoke.run_stream
        svc = sync.service(max_batch=8)
        want = [svc.submit(q) for q in tpcds_queries(sync)]
        svc.flush()
        hs, tables = run(serve())
        for w, t in zip(want, tables):
            _tables_bit_identical(t, w.result())
        assert [mqo_decision(h._inner) for h in hs] == \
            [mqo_decision(h) for h in want]
        got_spans = mqo_trace(asess.telemetry().tracer)
        assert got_spans == mqo_trace(sync.telemetry().tracer)
        assert len([s for s in got_spans if s[0] == "mqo.identify"]) == 7


# ---------------------------------------------------------------------------
# parity with the JAX package's async front
# ---------------------------------------------------------------------------
PARITY_ROWS = 4_000
PARITY_WINDOW = 6


def _family_query(P, sess, fam: int, lit: int):
    """One arrival of the three store_sales template families (the
    async traffic of ``chip_smoke.py`` phase A), in package ``P``."""
    t = sess.table("store_sales")
    if fam == 0:
        return t.filter(P.expr.cmp("ss_quantity", ">", lit)).project(
            "ss_item_sk", "ss_quantity")
    if fam == 1:
        return t.filter(P.expr.cmp("ss_item_sk", "<", lit * 20)).project(
            "ss_item_sk", "ss_sales_price")
    return t.filter(P.expr.and_(
        P.expr.cmp("ss_quantity", ">", lit),
        P.expr.cmp("ss_store_sk", ">", lit // 2))).project(
        "ss_quantity", "ss_net_profit")


def _serve_async(P, sess, strict_fp, plan_args):
    async def go():
        svc = P.AsyncQueryService(
            sess, clock=FakeClock(),
            config=P.AsyncConfig(max_batch=PARITY_WINDOW, max_wait_s=30.0))
        async with svc:
            hs = [await svc.submit(_family_query(P, sess, f, lit))
                  for f, lit in plan_args]
            await svc.flush()
            tables = await asyncio.gather(*hs)
        return hs, tables

    hs, tables = asyncio.run(go())
    decisions = [mqo_decision(h._inner, strict_fp) for h in hs]
    return ([host(t) for t in tables], decisions,
            mqo_trace(sess.telemetry().tracer))


def test_async_front_matches_the_jax_package():
    rng = np.random.default_rng(3)
    plan_args = [(k % 3, int(rng.integers(5, 95))) for k in range(15)]
    js, ts = sessions(generate_tpcds_catalog(PARITY_ROWS, 0), "csv")
    jt, jd, jw = _serve_async(R, js, j_strict, plan_args)
    tt, td, tw = _serve_async(T, ts, t_strict, plan_args)
    assert len(jt) == len(tt) == len(plan_args)
    for i, (a, b) in enumerate(zip(jt, tt)):
        assert_parity(a, b, f"q{i}")
    assert jd == td
    # three windows (6 + 6 + the flushed 3), each sharing work
    identify = [dict(a) for name, a in tw if name == "mqo.identify"]
    assert len(identify) == 3 and all(w["n_ses"] > 0 for w in identify)
    assert jw == tw

"""Reuse channels and failure handling, port against the JAX package.

Beyond the plain TPC-DS stream, the port carries the JAX package's
partition-grained caching (range / hash partitioning, pruning, the pid
bitset pool), semantic subsumption and the degradation ladder.  Each
scenario here runs in both packages over the same stored bytes
(``carry.storage_from_reference``) and compares results, MQO decisions
and what ``explain()`` reports, under the contract of
``torch_parity.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import repro.relational as R  # noqa: E402
import repro_torch.relational as T  # noqa: E402
from repro.core.faults import FaultConfig as JFaultConfig  # noqa: E402
from repro.core.fingerprint import strict_fingerprint as j_strict  # noqa
from repro.relational.datagen import (generate_columns,  # noqa: E402
                                      synthetic_schema)
from repro_torch.carry import storage_from_reference  # noqa: E402
from repro_torch.core.faults import FaultConfig as TFaultConfig  # noqa
from repro_torch.core.fingerprint import strict_fingerprint as t_strict
from repro_torch.relational.observe import mqo_decision  # noqa: E402
from torch_parity import assert_parity, host  # noqa: E402

SCHEMA = synthetic_schema(n_int=3, n_dbl=2, n_str=1)
NROWS = 8000
COLS = generate_columns(SCHEMA, NROWS, seed=11)
CPU = torch.device("cpu")


def _pair(fmt="columnar", partitioning=None, budget=1 << 26,
          faults=None):
    """A JAX and a port session holding table ``t`` (same bytes)."""
    out = []
    for P, fc in ((R, JFaultConfig), (T, TFaultConfig)):
        cfg = P.SessionConfig(memory=P.MemoryConfig(budget_bytes=budget))
        if faults is not None:
            cfg = cfg.with_faults(fc(**faults))
        kw = {} if P is R else {"device": CPU}
        sess = P.Session.from_config(cfg, **kw)
        sess.disk_latency_per_byte = 5e-9     # make caching worthwhile
        out.append(sess)
    js, ts = out
    st, _ = R.make_storage("t", SCHEMA, NROWS, fmt, cols=COLS)
    spec = (None if partitioning is None
            else (R.Partitioning(*partitioning),
                  T.Partitioning(*partitioning)))
    js.register(st, columnar_for_stats=COLS,
                partitioning=spec[0] if spec else None)
    ts.register(storage_from_reference(st), columnar_for_stats=COLS,
                partitioning=spec[1] if spec else None)
    return js, ts


def _dashboard(P, sess):
    E = P.expr
    t = sess.table
    return [
        t("t").filter(E.cmp("n1", "<", 400))
        .project("n1", "n2", "n3", "d1"),
        t("t").filter(E.cmp("n1", "<", 300)).project("n1", "n2", "d2"),
        t("t").filter(E.cmp("n1", "<", 350)).project("n1", "n3", "d1"),
    ]


def _window(sess, plans, strict_fp, max_batch=4):
    svc = sess.service(max_batch=max_batch)
    hs = [svc.submit(p) for p in plans]
    svc.flush()
    return hs, [host(h.result()) for h in hs], \
        [mqo_decision(h, strict_fp) for h in hs]


def _explain_keys(h):
    e = h.explain()
    return (e["subsumption_hit"], e["pid_pruned_parts"],
            e["resident_reuse"], e.get("subsumption", {}) and
            e["subsumption"]["residual"])


@pytest.mark.parametrize("budget", [1 << 26, 1 << 14])
@pytest.mark.parametrize("scheme", ["range", "hash"])
def test_partition_grained_windows_match_jax(scheme, budget):
    js, ts = _pair("csv", ("n1", scheme, 8), budget=budget)
    for _ in range(2):           # cold, then warm: residents re-priced
        jh, jt, jd = _window(js, _dashboard(R, js), j_strict)
        th, tt, td = _window(ts, _dashboard(T, ts), t_strict)
        for i, (a, b) in enumerate(zip(jt, tt)):
            assert_parity(a, b, f"{scheme}/{budget}/q{i}")
        assert jd == td
        assert [_explain_keys(h) for h in jh] == \
            [_explain_keys(h) for h in th]
        assert js.ce_resident_parts() == ts.ce_resident_parts()
        assert js.memory.device_used == ts.memory.device_used


@pytest.mark.parametrize("fmt", ["columnar", "csv"])
def test_pid_pruning_matches_jax(fmt):
    js, ts = _pair(fmt, ("n1", "range", 8))
    for _ in range(2):           # pass 1 records bitsets, pass 2 uses
        res = []
        for P, sess, fp in ((R, js, j_strict), (T, ts, t_strict)):
            E = P.expr
            qs = [sess.table("t").filter(E.and_(
                E.cmp("n1", "<", 700), E.cmp("n2", "<", 150)))
                .project("n1", "n2"),
                sess.table("t").filter(E.cmp("n3", ">=", 9000))
                .project("n1", "n3")]
            res.append(_window(sess, qs, fp, max_batch=1))
        (jh, jt, jd), (th, tt, td) = res
        for a, b in zip(jt, tt):
            assert_parity(a, b, f"pid/{fmt}")
        assert jd == td
        assert [_explain_keys(h) for h in jh] == \
            [_explain_keys(h) for h in th]
    assert ts._pid_pool.used_bytes == js._pid_pool.used_bytes > 0


def test_subsumption_resume_matches_jax():
    js, ts = _pair()
    out = []
    for P, sess, fp in ((R, js, j_strict), (T, ts, t_strict)):
        E = P.expr
        seeds = [sess.table("t").filter(E.cmp("n1", "<", 500))
                 .project("n1", "n2", "d1") for _ in range(3)]
        probe = sess.table("t").filter(E.and_(
            E.cmp("n1", "<", 300), E.cmp("n2", ">=", 400))).project("n1",
                                                                   "n2")
        _window(sess, seeds, fp)
        out.append(_window(sess, [probe], fp))
    (jh, jt, jd), (th, tt, td) = out
    assert_parity(jt[0], tt[0], "probe")
    assert jd == td
    assert _explain_keys(jh[0]) == _explain_keys(th[0])
    assert th[0].explain()["subsumption_hit"] is True


def test_degradation_ladder_matches_jax():
    """A failed batched launch sends the window to per-query dispatch,
    and scheduled kernel_launch faults step both ladders down the same
    rungs (named for each package's routes) to the same results."""
    faults = dict(seed=1, schedule={"batched_launch": (0,),
                                    "kernel_launch": (0, 2, 3)})
    js, ts = _pair(faults=faults)
    clean_j, clean_t = _pair()
    rename = {"pallas": "kernel", "fused-xla": "fused-torch"}
    for sess in (js, ts, clean_j, clean_t):
        sess._sleep = lambda s: None
    jb = js.run_batch(_dashboard(R, js))
    tb = ts.run_batch(_dashboard(T, ts))
    cj = clean_j.run_batch(_dashboard(R, clean_j))
    ct = clean_t.run_batch(_dashboard(T, clean_t))
    jev = [(e["query"], e["attempt"], e["action"],
            rename.get(e["level"], e["level"]))
           for e in jb.resilience.get("events", [])]
    tev = [(e["query"], e["attempt"], e["action"], e["level"])
           for e in tb.resilience.get("events", [])]
    assert jev == tev and any(a == "degrade" for _, _, a, _ in tev)
    for a, b, c in zip(tb.results, ct.results, jb.results):
        assert_parity(host(c.table), host(a.table), "faulted")
        assert_parity(host(b.table), host(a.table), "clean", rtol=0)
    assert not ct.resilience.get("events") and not cj.resilience.get(
        "events")
    assert all(r is not None for r in tb.results)

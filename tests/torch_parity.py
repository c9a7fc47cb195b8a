"""Shared parity harness of the port's slice tests (not a test module).

Builds one JAX and one port session over the same stored bytes, runs a
query stream through ``QueryService`` windows, and compares the results
and MQO decisions under the parity contract.

Parity contract:
  * exact — rows, row order, row counts, int and string columns, and
    the MQO decisions (the rewritten plan, every CE it consumes with its
    SE psi / strict key / consumers / value / weight / residency, and
    the rewritten plan's strict fingerprint);
  * f32 columns within F32_RTOL: the JAX package sums f32 aggregates
    sequentially in f32, the port through f64 prefix sums, so a sum may
    round differently (relative error of a sequential f32 sum of n
    terms is at most about n * 6e-8; the TPC-DS groups here hold a few
    hundred rows).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import repro.relational as R
import repro_torch.relational as T
from repro.core.fingerprint import strict_fingerprint as j_strict
from repro_torch.carry import storage_from_reference
from repro_torch.core.fingerprint import strict_fingerprint as t_strict
from repro_torch.relational.observe import mqo_decision, mqo_trace

F32_RTOL = 1e-4
WINDOW = 8
CPU = torch.device("cpu")


def sessions(catalog, fmt, budget=1 << 26, **exec_kw):
    """One JAX and one port session over the same stored bytes."""
    jcfg = R.SessionConfig(memory=R.MemoryConfig(budget_bytes=budget))
    tcfg = T.SessionConfig(memory=T.MemoryConfig(budget_bytes=budget))
    if exec_kw:
        jcfg = jcfg.with_execution(**exec_kw)
        tcfg = tcfg.with_execution(**exec_kw)
    js = R.Session.from_config(jcfg)
    ts = T.Session.from_config(tcfg, device=CPU)
    js.enable_tracing()
    ts.enable_tracing()
    for name, (schema, nrows, cols) in catalog.items():
        st, _ = R.make_storage(name, schema, nrows, fmt, cols=cols)
        js.register(st, columnar_for_stats=cols)
        ts.register(storage_from_reference(st), columnar_for_stats=cols)
    return js, ts


def stream(sess, queries, strict_fp):
    """Run ``queries`` through one QueryService window stream; returns
    (host tables, decisions, trace (hits, misses) of this stream); the
    decisions are the per-query ones followed by the window-level
    :func:`mqo_trace`."""
    reg = sess.telemetry().registry
    h0, m0 = reg.value("trace.hits"), reg.value("trace.misses")
    svc = sess.service(max_batch=WINDOW)
    handles = [svc.submit(q) for q in queries]
    svc.flush()
    tables = [host(h.result()) for h in handles]
    decisions = [mqo_decision(h, strict_fp) for h in handles]
    decisions.append(mqo_trace(sess.telemetry().tracer))
    trace = (reg.value("trace.hits") - h0, reg.value("trace.misses") - m0)
    return tables, decisions, trace


def host(t):
    return t.schema, t.nrows, {n: np.asarray(a) for n, a in
                               t.to_numpy().items()}


def assert_parity(want, got, label, rtol=F32_RTOL):
    (ws, wn, wc), (gs, gn, gc) = want, got
    assert ws.names == gs.names and [t.kind for _, t in ws.fields] == \
        [t.kind for _, t in gs.fields], label
    assert wn == gn, (label, wn, gn)
    for name, t in ws.fields:
        x, y = wc[name], gc[name]
        assert x.dtype == y.dtype, (label, name, x.dtype, y.dtype)
        if t.kind == "f32" and rtol:
            np.testing.assert_allclose(y, x, rtol=rtol, atol=0,
                                       err_msg=f"{label}.{name}")
        else:
            assert np.array_equal(x, y), (label, name)


def run_both(catalog, fmt, jq, tq, passes=2):
    js, ts = sessions(catalog, fmt)
    out = []
    for p in range(passes):
        out.append((stream(js, jq(js), j_strict),
                    stream(ts, tq(ts), t_strict)))
    return out


def to_reference(obj):
    """A port plan, predicate or schema rebuilt as the JAX package's:
    each of the port's dataclasses becomes the class of the same name in
    the JAX package's module of the same path, field by field."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_reference(o) for o in obj)
    mod = type(obj).__module__
    if dataclasses.is_dataclass(obj) and mod.startswith("repro_torch."):
        cls = getattr(importlib.import_module(
            "repro." + mod[len("repro_torch."):]), type(obj).__name__)
        return cls(**{f.name: to_reference(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    return obj


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's torch ops on one thread: the LLM tests launch
    thousands of tiny ops, which gain nothing from intra-op threads and
    stall when parallel test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

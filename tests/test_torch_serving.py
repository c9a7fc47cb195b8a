"""The port's prefix-cache MQO serving engine against the JAX package.

Both engines serve the workloads of ``tests/test_serving_mqo.py`` with
the same parameters (carried across) under its budgets.  Exact: SE and
selected-CE counts, tokens prefilled, pool bytes and every generated
token (greedy argmax over f32 logits that agree to about 2e-4).  Inside
the port: MQO on = off, warm < cold, ``retain_states=False``, and a
pooled prefix state is never changed by the requests that resume from
it.
"""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.model import init_params as j_init_params
from repro.serving.costs import ServingCostModel as JCost
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import GenerationRequest as JRequest
from repro_torch.carry import params_from_reference
from repro_torch.configs import get_config, list_configs
from repro_torch.models.decoder import map_cache
from repro_torch.models.model import init_params
from repro_torch.serving import engine as E
from repro_torch.serving.costs import ServingCostModel
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import (GenerationRequest,
                                         identify_shared_prefixes,
                                         plan_requests)
from torch_parity import one_torch_thread  # noqa: F401

CPU = "cpu"
pytestmark = pytest.mark.usefixtures("one_torch_thread")
SMALL, LARGE = 1 << 14, 1 << 22


def _requests(make, vocab, n_shared=3, shared_len=96, tail=12, seed=0):
    """The workload of ``tests/test_serving_mqo.py::_requests``."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, shared_len)
    reqs = [make(i, np.concatenate([shared, rng.integers(
        0, vocab, tail + i)]).astype(np.int32), 4) for i in range(n_shared)]
    reqs.append(make(99, rng.integers(0, vocab, 40).astype(np.int32), 4))
    return reqs


@pytest.fixture(scope="module")
def engines_params():
    jcfg = replace(j_get_config("granite-8b-smoke"), n_prefix_tokens=0)
    tcfg = replace(get_config("granite-8b-smoke"), n_prefix_tokens=0)
    jp = j_init_params(jcfg, 0)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _report_key(rep):
    return (rep.n_ses, rep.n_selected, rep.tokens_prefilled,
            rep.tokens_prefilled_baseline, rep.pool_used)


@pytest.mark.parametrize("n_shared", [3, 4])
@pytest.mark.parametrize("budget", [SMALL, LARGE])
def test_engine_matches_the_reference(engines_params, budget, n_shared):
    """Baseline, MQO cold and MQO warm on one engine of each package."""
    jcfg, tcfg, jp, tp = engines_params
    jeng = JEngine(jcfg, jp, pool_budget_bytes=budget, block_size=32,
                   max_len=192)
    teng = ServingEngine(tcfg, tp, pool_budget_bytes=budget, block_size=32,
                         max_len=192)
    for mqo in (False, True, True):
        want, jrep = jeng.run_batch(_requests(JRequest, jcfg.vocab_size,
                                              n_shared), mqo=mqo)
        got, trep = teng.run_batch(_requests(GenerationRequest,
                                             tcfg.vocab_size, n_shared),
                                   mqo=mqo)
        assert _report_key(trep) == _report_key(jrep)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == np.int32 and np.array_equal(a, b)
    assert set(teng.pool.keys()) == set(jeng.pool.keys())


def test_mqo_on_equals_off_and_warm_beats_cold(engines_params):
    _, tcfg, _, tp = engines_params
    eng = ServingEngine(tcfg, tp, pool_budget_bytes=LARGE, block_size=32,
                        max_len=192)

    def mk():
        return _requests(GenerationRequest, tcfg.vocab_size)

    base, rep_base = eng.run_batch(mk(), mqo=False)
    cold, rep_cold = eng.run_batch(mk(), mqo=True)
    warm, rep_warm = eng.run_batch(mk(), mqo=True)
    assert rep_cold.n_selected >= 1
    assert rep_warm.tokens_prefilled < rep_cold.tokens_prefilled \
        < rep_base.tokens_prefilled
    for outs in (cold, warm):
        assert all(np.array_equal(a, b) for a, b in zip(base, outs))


def test_retain_states_off_restores_cold_batches(engines_params):
    _, tcfg, _, tp = engines_params
    eng = ServingEngine(tcfg, tp, pool_budget_bytes=LARGE, block_size=32,
                        max_len=192, retain_states=False)
    mk = lambda: _requests(GenerationRequest, tcfg.vocab_size)  # noqa: E731
    _, rep1 = eng.run_batch(mk(), mqo=True)
    _, rep2 = eng.run_batch(mk(), mqo=True)
    assert rep2.tokens_prefilled == rep1.tokens_prefilled > 0


def _snapshot(pool):
    return {psi: (map_cache(pool.get(psi)[0], torch.clone),
                  pool.get(psi)[1]) for psi in pool.keys()}


def test_pooled_prefixes_are_not_changed_by_their_consumers(
        engines_params, monkeypatch):
    """Decode writes caches in place: every request that resumes from a
    pooled prefix, and every longer prefix chained onto it, must work
    on a copy.  Batch A admits a 64-token prefix; batch B shares 96
    tokens, so its prefix chains onto A's resident state."""
    _, tcfg, _, tp = engines_params
    eng = ServingEngine(tcfg, tp, pool_budget_bytes=LARGE, block_size=32,
                        max_len=192)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, tcfg.vocab_size, 96)

    def batch(n_shared_tokens, ids):
        return [GenerationRequest(i, np.concatenate(
            [shared[:n_shared_tokens], np.random.default_rng(i).integers(
                0, tcfg.vocab_size, 20 + i)]).astype(np.int32), 4)
            for i in ids]

    chained = []
    real = eng._longest_cached_ancestor
    monkeypatch.setattr(eng, "_longest_cached_ancestor", lambda c, p: (
        chained.append(real(c, p)) or chained[-1]))
    outs = {}
    for name, n_tok, ids in (("A", 64, (1, 2, 3)), ("B", 96, (4, 5, 6))):
        outs[name] = [eng.run_batch(batch(n_tok, ids), mqo=mqo)[0]
                      for mqo in (False, True, True)]
        if name == "A":
            before = _snapshot(eng.pool)
            assert [n for _, n in before.values()] == [64]
    assert any(psi is not None and n == 64 for psi, n in chained)
    after = _snapshot(eng.pool)
    assert sorted(n for _, n in after.values()) == [64, 96]
    for psi, (cache, n_tok) in list(before.items()) + list(after.items()):
        flat_a, flat_b = [], []
        map_cache(cache, flat_a.append)
        map_cache(_snapshot(eng.pool)[psi][0], flat_b.append)
        assert all(torch.equal(a, b) for a, b in zip(flat_a, flat_b))
        # the state holds exactly its n_tok tokens: nothing was written
        # past them
        assert all(not a[:, :, n_tok:].any() for a in flat_a)
    for base, cold, warm in outs.values():
        for other in (cold, warm):
            assert all(np.array_equal(a, b) for a, b in zip(base, other))


def test_a_state_resumes_as_a_private_copy(engines_params):
    _, tcfg, _, tp = engines_params
    eng = ServingEngine(tcfg, tp, pool_budget_bytes=LARGE, block_size=32,
                        max_len=192)
    reqs = plan_requests(_requests(GenerationRequest, tcfg.vocab_size), 32)
    eng.run_batch(_requests(GenerationRequest, tcfg.vocab_size), mqo=True)
    cache, n_tok = eng._resume_point(reqs[0], eng.pool)
    assert n_tok > 0
    pooled = next(eng.pool.get(psi)[0] for psi in eng.pool.keys()
                  if eng.pool.get(psi)[1] == n_tok)
    k_pool = pooled["scan"][0]["0"]["k"]
    k_copy = cache["scan"][0]["0"]["k"]
    assert torch.equal(k_pool, k_copy)
    assert k_pool.data_ptr() != k_copy.data_ptr()


def test_engine_runs_where_its_parameters_are(engines_params):
    _, tcfg, _, tp = engines_params
    eng = ServingEngine(tcfg, tp, pool_budget_bytes=SMALL)
    assert eng.device == torch.device("cpu")
    cache = eng._fresh_cache()
    assert cache["scan"][0]["0"]["k"].device.type == "cpu"
    assert cache["scan"][0]["0"]["k"].dtype == torch.float32


def test_spilled_states_come_back_to_the_engine_device(engines_params):
    _, tcfg, _, tp = engines_params
    eng = ServingEngine(tcfg, tp, pool_budget_bytes=SMALL)
    state = ({"scan": [{"0": {"k": torch.ones(2)}}]}, 5)
    host = eng._state_to_host(state)
    back = eng._state_to_device(host)
    assert back[1] == 5
    assert back[0]["scan"][0]["0"]["k"].device == eng.device
    assert torch.equal(back[0]["scan"][0]["0"]["k"], torch.ones(2))


def test_prefill_and_generate_loops_match_decode_steps(engines_params):
    """The loops that replace the JAX package's scans: one decode step
    per token, greedy argmax fed back."""
    _, tcfg, _, tp = engines_params
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (1, 9)))
    eng = ServingEngine(tcfg, tp, pool_budget_bytes=SMALL, max_len=64)
    cache, last = E._prefill_scan(tp, eng._fresh_cache(), toks, 0, tcfg)
    gen, _ = E._generate_scan(tp, cache, toks[:, -1:], 9, tcfg, 3)
    from repro_torch.models.model import decode_step

    ref = eng._fresh_cache()
    for i in range(9):
        lg, ref = decode_step(tp, ref, toks[:, i:i + 1], i, tcfg)
    assert torch.equal(lg, last)
    tok, out = toks[:, -1:], []
    for i in range(3):
        lg, ref = decode_step(tp, ref, tok, 9 + i, tcfg)
        tok = lg.argmax(-1)[:, None]
        out.append(int(tok))
    assert gen[0].tolist() == out


def test_cost_model_matches_the_reference_for_every_config():
    """Knapsack weights and values price exactly as the reference's, so
    MCKP choices agree."""
    for name in list_configs():
        t, j = ServingCostModel(get_config(name)), JCost(j_get_config(name))
        for n in (1, 64, 1000, 8192):
            assert t.state_bytes(n) == j.state_bytes(n)
            assert t.prefill_flops(n) == j.prefill_flops(n)


def test_shared_prefixes_match_the_reference():
    from repro.serving.request import \
        identify_shared_prefixes as j_identify
    from repro.serving.request import plan_requests as j_plan

    vocab = 512
    t = identify_shared_prefixes(plan_requests(
        _requests(GenerationRequest, vocab, shared_len=128), 32), k=2)
    j = j_identify(j_plan(_requests(JRequest, vocab, shared_len=128), 32),
                   k=2)
    assert [se.psi for se in t] == [se.psi for se in j]
    assert sorted(se.occurrences[0].node.n_tokens for se in t) == \
        [32, 64, 96, 128]


def test_engine_telemetry_counts_and_spans(engines_params):
    from repro_torch.relational.observe import Telemetry

    _, tcfg, _, tp = engines_params
    tel = Telemetry()
    tel.enable_tracing()
    eng = ServingEngine(tcfg, tp, pool_budget_bytes=LARGE, block_size=32,
                        max_len=192, telemetry=tel)
    _, rep = eng.run_batch(_requests(GenerationRequest, tcfg.vocab_size))
    reg = tel.registry
    assert reg.value("serving.batches") == 1
    assert reg.value("serving.tokens_prefilled") == rep.tokens_prefilled
    names = {s.name for s in tel.tracer.finished}
    assert {"serving.identify", "serving.solve",
            "serving.materialize"} <= names


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_params(get_config("granite-8b-smoke"), 0)

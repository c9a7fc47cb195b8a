"""The prefix-cache MQO engine over the Mamba, RG-LRU, MoE and MLA
families, against the JAX package's engine.

Both engines serve ``tests/test_serving_mqo.py``'s workload on the four
``-smoke`` configs with the same parameters (carried across).  Exact:
SE and selected-CE counts, tokens prefilled, pool bytes, the pooled
prefixes and every generated token (greedy argmax over f32 logits that
agree within 1e-3).  Inside the port: SSM prefix caching keeps
generations identical at a length-free state weight; pooled SSM, RG-LRU
and MLA states are never changed by the requests that resume from them;
spilled states come back to the engine's device and serve the same
tokens.
"""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.model import init_params as j_init_params
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import GenerationRequest as JRequest
from repro_torch.carry import params_from_reference
from repro_torch.configs import get_config
from repro_torch.models.decoder import map_cache
from repro_torch.models.model import init_params
from repro_torch.serving.costs import ServingCostModel
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import GenerationRequest
from torch_parity import one_torch_thread  # noqa: F401

CPU = "cpu"
pytestmark = pytest.mark.usefixtures("one_torch_thread")
FAMILIES = ("falcon-mamba-7b-smoke", "recurrentgemma-9b-smoke",
            "llama4-scout-17b-a16e-smoke", "deepseek-v2-236b-smoke")
# the families whose decode state is not a KV cache
STATE_KINDS = {"mamba": "falcon-mamba-7b-smoke",
               "rglru": "recurrentgemma-9b-smoke",
               "mla": "deepseek-v2-236b-smoke"}
SMALL, LARGE = 1 << 14, 1 << 20


def _requests(make, vocab, n_shared=3, shared_len=96, tail=12, seed=0):
    """The workload of ``tests/test_serving_mqo.py::_requests``."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, shared_len)
    reqs = [make(i, np.concatenate([shared, rng.integers(
        0, vocab, tail + i)]).astype(np.int32), 4) for i in range(n_shared)]
    reqs.append(make(99, rng.integers(0, vocab, 40).astype(np.int32), 4))
    return reqs


def _report_key(rep):
    return (rep.n_ses, rep.n_selected, rep.tokens_prefilled,
            rep.tokens_prefilled_baseline, rep.pool_used)


def _port(arch):
    cfg = replace(get_config(arch), n_prefix_tokens=0)
    return cfg, init_params(cfg, 0, CPU)


@pytest.mark.parametrize("budget", [SMALL, LARGE])
@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_matches_the_reference(arch, budget):
    """Baseline, MQO cold and MQO warm on one engine of each package."""
    jcfg = replace(j_get_config(arch), n_prefix_tokens=0)
    tcfg = replace(get_config(arch), n_prefix_tokens=0)
    jp = j_init_params(jcfg, 0)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg, CPU)
    jeng = JEngine(jcfg, jp, pool_budget_bytes=budget, block_size=32,
                   max_len=192)
    teng = ServingEngine(tcfg, tp, pool_budget_bytes=budget, block_size=32,
                         max_len=192)
    for mqo in (False, True, True):
        want, jrep = jeng.run_batch(_requests(JRequest, jcfg.vocab_size),
                                    mqo=mqo)
        got, trep = teng.run_batch(_requests(GenerationRequest,
                                             tcfg.vocab_size), mqo=mqo)
        assert _report_key(trep) == _report_key(jrep)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == np.int32 and np.array_equal(a, b)
    assert set(teng.pool.keys()) == set(jeng.pool.keys())


def test_ssm_prefix_caching_keeps_generations():
    """``tests/test_serving_mqo.py::test_ssm_arch_prefix_caching`` on
    the port: MQO on = off, and the SSM state weighs the same at any
    prefix length."""
    cfg, params = _port("falcon-mamba-7b-smoke")
    eng = ServingEngine(cfg, params, pool_budget_bytes=LARGE, block_size=32,
                        max_len=192)

    def mk():
        return _requests(GenerationRequest, cfg.vocab_size)

    base, _ = eng.run_batch(mk(), mqo=False)
    opt, rep = eng.run_batch(mk(), mqo=True)
    assert rep.n_selected >= 1
    assert all(np.array_equal(a, b) for a, b in zip(base, opt))
    cm = ServingCostModel(cfg)
    assert cm.state_bytes(1000) == cm.state_bytes(10)


def _flat(cache) -> list:
    out = []
    map_cache(cache, out.append)
    return out


def _snapshot(pool):
    return {psi: [t.clone() for t in _flat(pool.get(psi)[0])]
            for psi in pool.keys()}


@pytest.mark.parametrize("kind", sorted(STATE_KINDS))
def test_pooled_states_are_not_changed_by_their_consumers(kind,
                                                          monkeypatch):
    """Decode writes every state in place: each request that resumes
    from a pooled prefix, and each longer prefix chained onto it, must
    work on a copy.  Batch A admits 64-token prefixes; batch B shares 96
    tokens, so its prefix chains onto A's resident state."""
    cfg, params = _port(STATE_KINDS[kind])
    eng = ServingEngine(cfg, params, pool_budget_bytes=LARGE, block_size=32,
                        max_len=192)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab_size, 96)

    def batch(n_shared_tokens, ids):
        return [GenerationRequest(i, np.concatenate(
            [shared[:n_shared_tokens], np.random.default_rng(i).integers(
                0, cfg.vocab_size, 20 + i)]).astype(np.int32), 4)
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
            assert before
    assert any(psi is not None for psi, _ in chained)
    after = _snapshot(eng.pool)
    assert set(before) < set(after)
    eng.run_batch(batch(96, (4, 5, 6)), mqo=True)
    for snap in (before, after):
        for psi, leaves in snap.items():
            now = _flat(eng.pool.get(psi)[0])
            assert all(torch.equal(a, b) for a, b in zip(leaves, now))
    for base, cold, warm in outs.values():
        for other in (cold, warm):
            assert all(np.array_equal(a, b) for a, b in zip(base, other))


@pytest.mark.parametrize("kind", sorted(STATE_KINDS))
def test_spilled_states_come_back_to_the_engine_device(kind):
    """A pool that holds one state: batch B's prefix spills batch A's to
    the host tier; batch A again resumes from it through the unspill,
    on the engine's device, in the cache dtype, with the same tokens."""
    cfg, params = _port(STATE_KINDS[kind])
    rng = np.random.default_rng(7)
    templates = [rng.integers(0, cfg.vocab_size, 64) for _ in range(2)]

    def batch(t):
        return [GenerationRequest(i, np.concatenate(
            [templates[t], rng.integers(0, cfg.vocab_size, 5 + i)]).astype(
                np.int32), 3) for i in range(3)]

    budget = ServingCostModel(cfg).state_bytes(64)
    eng = ServingEngine(cfg, params, pool_budget_bytes=budget,
                        block_size=32, max_len=128)
    batch_a = batch(0)
    base, _ = eng.run_batch(batch_a, mqo=False)
    eng.run_batch(batch_a, mqo=True)
    (psi_a,) = eng.pool.keys()
    state_a = [t.clone() for t in _flat(eng.pool.get(psi_a)[0])]
    eng.run_batch(batch(1), mqo=True)
    assert eng.pool.entry(psi_a).tier == "host"
    assert all(t.device.type == "cpu" for t in
               _flat(eng.pool.entry(psi_a).payload[0]))
    again, rep = eng.run_batch(batch_a, mqo=True)
    assert rep.tokens_prefilled < sum(len(r.prompt) for r in batch_a)
    assert all(np.array_equal(a, b) for a, b in zip(base, again))
    back = _flat(eng.pool.get(psi_a)[0])
    assert all(t.device == eng.device and t.dtype == torch.float32
               for t in back)
    assert all(torch.equal(a, b) for a, b in zip(state_a, back))

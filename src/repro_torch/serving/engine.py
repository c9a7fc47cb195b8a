"""Batched serving engine with cache-based multi-request optimization.

The paper's four phases over a batch of generation requests:

  1. identify shared full-block prefixes (Merkle chain fingerprints);
  2. covering expressions are the shared prefixes themselves (strict
     identity -> merge is the identity, extraction = resume);
  3. MCKP admission into the device state pool under a byte budget,
     with Algorithm-2 groups (nested prefixes are mutually exclusive
     options under their longest selected ancestor);
  4. rewrite: each request prefills only its suffix from the longest
     admitted prefix state; admitted prefixes chain onto each other.

Guarantee (tested): generations are bit-identical with MQO on or off —
prefix state reuse is exact, the optimization only removes recompute.
Decode steps update a cache in place, so a state taken from the pool is
cloned before anything is prefilled onto it: a pooled prefix never
changes once admitted.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.cache import CacheManager
from ..core.candidates import generate_knapsack_items
from ..core.costmodel import price_ces
from ..core.covering import build_covering_expressions
from ..core.fingerprint import fingerprint
from ..core.mckp import solve_mckp
from ..core.memory import MemoryManager
from ..core.telemetry import NOOP_SPAN
from ..models.config import ArchConfig
from ..models.decoder import init_cache, map_cache
from ..models.model import compute_dtype, decode_step
from .costs import ServingCostModel
from .request import (GenerationRequest, TokenBlock,
                      identify_shared_prefixes, plan_requests)


@torch.inference_mode()
def _prefill_scan(params, cache, tokens: torch.Tensor, start_len: int,
                  cfg: ArchConfig):
    """Sequential cache-filling prefill: one decode step per token.

    tokens: (B, T) on the parameters' device.  Returns (cache, last
    logits (B, V)); the cache is filled in place.
    """
    logits = None
    for i in range(tokens.shape[1]):
        logits, cache = decode_step(params, cache, tokens[:, i:i + 1],
                                    start_len + i, cfg)
    return cache, logits


@torch.inference_mode()
def _generate_scan(params, cache, first_tok: torch.Tensor, start_len: int,
                   cfg: ArchConfig, n_new: int):
    """Greedy generation of ``n_new`` tokens (argmax on the logits' own
    dtype, first maximum on ties).  Returns ((B, n_new) tokens, cache);
    nothing waits for the device until the caller reads the tokens."""
    tok, toks = first_tok, []
    for i in range(n_new):
        logits, cache = decode_step(params, cache, tok, start_len + i, cfg)
        tok = torch.argmax(logits, dim=-1)[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1), cache


@dataclass
class ServingReport:
    n_requests: int = 0
    n_ses: int = 0
    n_selected: int = 0
    pool_budget: int = 0
    pool_used: int = 0
    tokens_prefilled: int = 0
    tokens_prefilled_baseline: int = 0
    prefill_flops_saved: float = 0.0
    optimize_seconds: float = 0.0
    wall_seconds: float = 0.0

    @property
    def prefill_token_ratio(self) -> float:
        base = max(self.tokens_prefilled_baseline, 1)
        return self.tokens_prefilled / base


def _clone_state(cache):
    return map_cache(cache, torch.clone)


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params, *,
                 pool_budget_bytes: int, block_size: int = 64,
                 max_len: int = 512, k: int = 2,
                 policy: str = "lru",
                 retain_states: bool = True,
                 telemetry=None):
        self.cfg = cfg
        self.params = params
        # the engine runs where its parameters live
        self.device = next(params.parameters()).device
        self.block_size = block_size
        self.max_len = max_len
        self.k = k
        self.cost_model = ServingCostModel(cfg)
        self.pool_budget = int(pool_budget_bytes)
        # optional relational.observe.Telemetry: phase spans + counters
        # for the serving-side MQO; None costs one attribute check per
        # batch
        self.telemetry = telemetry
        # prefix states are admitted through the unified memory
        # hierarchy: the device budget is enforced by the manager,
        # eviction under pressure, spill tier = host memory offload of
        # the KV state.  Retained across batches (prefix fingerprints
        # are Merkle chains over token CONTENT, so cross-batch reuse is
        # exact) unless retain_states=False.  The host tier is bounded
        # at 4x the device budget, as in relational.Session.
        self.retain_states = retain_states
        self.memory = MemoryManager(self.pool_budget,
                                    host_budget=4 * self.pool_budget,
                                    policy=policy)
        self.pool = CacheManager(
            self.pool_budget, spill_fn=self._state_to_host,
            unspill_fn=self._state_to_device, manager=self.memory,
            pool="prefix")
        if telemetry is not None:
            self.memory.telemetry = telemetry

    @staticmethod
    def _state_to_host(payload):
        """Spill a prefix state (cache tree, n_tokens) device -> host."""
        cache, n_tok = payload
        return (map_cache(cache, lambda a: a.cpu()), n_tok)

    def _state_to_device(self, payload):
        cache, n_tok = payload
        return (map_cache(cache, lambda a: a.to(self.device)), n_tok)

    def _span(self, name: str, **attrs):
        tel = self.telemetry
        if tel is not None and tel.tracer.enabled:
            return tel.tracer.span(name, **attrs)
        return NOOP_SPAN

    def _fresh_cache(self, batch: int = 1):
        return init_cache(self.cfg, batch, self.max_len,
                          compute_dtype(self.cfg), self.device)

    def _tokens(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.int64)[None],
                               device=self.device)

    # ------------------------------------------------------------------
    def run_batch(self, requests: Sequence[GenerationRequest], *,
                  mqo: bool = True) -> Tuple[List[np.ndarray],
                                             ServingReport]:
        report = ServingReport(n_requests=len(requests),
                               pool_budget=self.pool_budget)
        t_wall = time.perf_counter()
        requests = plan_requests(list(requests), self.block_size)
        report.tokens_prefilled_baseline = sum(len(r.prompt)
                                               for r in requests)

        if mqo:
            if not self.retain_states:
                self.pool.clear()
            pool = self.pool
        else:
            # the no-MQO baseline stays cold: an empty throwaway pool,
            # so retained states never leak into baseline measurements
            pool = CacheManager(self.pool_budget)
        if mqo:
            t0 = time.perf_counter()
            with self._span("serving.identify",
                            n_requests=len(requests)):
                ses = identify_shared_prefixes(requests, k=self.k)
            report.n_ses = len(ses)
            ces = build_covering_expressions(ses)
            price_ces(ces, self.cost_model)
            items = generate_knapsack_items(ces)
            with self._span("serving.solve", n_items=len(items),
                            budget=self.pool_budget):
                sol = solve_mckp(items, self.pool_budget)
            report.optimize_seconds = time.perf_counter() - t0
            report.n_selected = len(sol.ces)

            # materialize admitted prefixes, chaining longer onto shorter
            with self._span("serving.materialize",
                            n_selected=len(sol.ces)):
                for ce in sorted(sol.ces, key=lambda c: c.tree.n_tokens):
                    chain: TokenBlock = ce.tree
                    if pool.touch(ce.psi):
                        # cross-batch hit: the state is already
                        # materialized (prefix fingerprints are
                        # content-exact), skip the prefill entirely —
                        # the full CE value is saved.  touch() refreshes
                        # LRU recency WITHOUT paying an unspill:
                        # consumers unspill/promote on demand in
                        # _resume_point.
                        report.prefill_flops_saved += ce.value * (
                            self.cost_model.chips * 1.0)
                        continue
                    anc_psi, anc_len = self._longest_cached_ancestor(
                        chain, pool)
                    if anc_psi is not None:
                        cache = _clone_state(pool.get(anc_psi)[0])
                    else:
                        cache, anc_len = self._fresh_cache(), 0
                    delta = chain.full_tokens()[anc_len:]
                    cache, _ = _prefill_scan(
                        self.params, cache, self._tokens(delta), anc_len,
                        self.cfg)
                    report.tokens_prefilled += len(delta)
                    pool.put(ce.psi, (cache, chain.n_tokens),
                             nbytes=self.cost_model.state_bytes(
                                 chain.n_tokens),
                             est_bytes=ce.weight,
                             benefit=max(float(ce.value), 0.0))
                    report.prefill_flops_saved += ce.value * (
                        self.cost_model.chips * 1.0)

        # rewrite + execute every request; generated tokens stay on the
        # device until every request has been launched
        generated = []
        for r in requests:
            cache, start = self._resume_point(r, pool)
            suffix = np.concatenate(
                [r.chain.full_tokens()[start:] if r.chain is not None
                 else np.zeros(0, np.int32), r.tail])
            if len(suffix) > 1:
                cache, _ = _prefill_scan(
                    self.params, cache, self._tokens(suffix[:-1]), start,
                    self.cfg)
                report.tokens_prefilled += len(suffix) - 1
            toks, _ = _generate_scan(
                self.params, cache, self._tokens(suffix[-1:]),
                len(r.prompt) - 1, self.cfg, r.max_new_tokens)
            generated.append(toks[0])
        outputs = [t.cpu().numpy().astype(np.int32) for t in generated]

        report.pool_used = pool.used_bytes
        report.wall_seconds = time.perf_counter() - t_wall
        if self.telemetry is not None:
            reg = self.telemetry.registry
            reg.inc("serving.batches")
            reg.inc("serving.requests", len(requests))
            reg.inc("serving.tokens_prefilled", report.tokens_prefilled)
            reg.inc("serving.tokens_prefilled_baseline",
                    report.tokens_prefilled_baseline)
        return outputs, report

    # ------------------------------------------------------------------
    def _longest_cached_ancestor(self, chain: TokenBlock,
                                 pool: CacheManager):
        node = chain.prev
        while node is not None:
            psi = fingerprint(node)
            if pool.contains(psi):
                return psi, node.n_tokens
            node = node.prev
        return None, 0

    def _resume_point(self, r: GenerationRequest, pool: CacheManager):
        """A private copy of the longest admitted prefix state of ``r``
        (or a fresh cache) and its token count."""
        node = r.chain
        while node is not None:
            psi = fingerprint(node)
            if pool.contains(psi):
                cache, n_tok = pool.get(psi)
                return _clone_state(cache), n_tok
            node = node.prev
        return self._fresh_cache(), 0

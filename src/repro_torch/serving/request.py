"""Generation requests and token-block prefix plans.

The beyond-paper instantiation of the paper's machinery: a request's
prompt is quantized into blocks of ``block_size`` tokens; the chain of
full blocks forms a unary plan whose Merkle fingerprint (core
Definition 2) identifies shared prefixes across a batch — the serving
analog of similar subexpressions.  Token blocks use STRICT identity
(attrs = the tokens themselves): prefixes share work only when
identical, so covering expressions are identities and extraction plans
are pure "resume from cached state".
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_BLOCK_SIZE = 64


@dataclass(frozen=True)
class TokenBlock:
    """One block of the prefix chain.  children = (previous block,)."""

    tokens: Tuple[int, ...]
    prev: Optional["TokenBlock"] = None
    depth: int = 0                      # blocks before this one

    # --- PlanNode protocol -------------------------------------------------
    @property
    def children(self):
        return (self.prev,) if self.prev is not None else ()

    @property
    def label(self) -> str:
        return "blk"

    loose = False
    cache_friendly = True
    commutative = True          # unary/leaf: irrelevant, set for protocol

    @property
    def strict_attrs(self):
        return self.tokens

    @property
    def n_tokens(self) -> int:
        return (self.depth + 1) * len(self.tokens)

    def merge(self, others):
        return self             # strict identity -> members are identical

    def with_children(self, children):
        if not children:
            return TokenBlock(self.tokens, None, 0)
        (prev,) = children
        return TokenBlock(self.tokens, prev, prev.depth + 1)

    def full_tokens(self) -> np.ndarray:
        parts: List[Tuple[int, ...]] = []
        node: Optional[TokenBlock] = self
        while node is not None:
            parts.append(node.tokens)
            node = node.prev
        return np.asarray([t for blk in reversed(parts) for t in blk],
                          np.int32)


@dataclass
class GenerationRequest:
    request_id: int
    prompt: np.ndarray                  # (T,) int32
    max_new_tokens: int = 16
    # filled by the planner:
    chain: Optional[TokenBlock] = None  # last FULL block of the prompt
    tail: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))


def build_chain(prompt: np.ndarray, block_size: int
                ) -> Tuple[Optional[TokenBlock], np.ndarray]:
    """Quantize a prompt into its full-block chain + unshared tail."""
    n_full = len(prompt) // block_size
    node: Optional[TokenBlock] = None
    for i in range(n_full):
        blk = tuple(int(t) for t in prompt[i * block_size:
                                           (i + 1) * block_size])
        node = TokenBlock(blk, node, i)
    tail = np.asarray(prompt[n_full * block_size:], np.int32)
    return node, tail


def plan_requests(requests: Sequence[GenerationRequest],
                  block_size: int = DEFAULT_BLOCK_SIZE
                  ) -> List[GenerationRequest]:
    for r in requests:
        r.chain, r.tail = build_chain(r.prompt, block_size)
    return list(requests)


def identify_shared_prefixes(requests: Sequence[GenerationRequest],
                             k: int = 2):
    """Serving adaptation of Algorithm 1.

    Plans are unary chains, so the paper's stop-at-the-highest-friendly
    -node heuristic would only ever record whole prompts; the chain
    analog enumerates EVERY full-block prefix into the fingerprint
    table (a chain of depth n has exactly n sub-plans — no search-space
    explosion to prune).  Threshold k keeps prefixes shared by >= k
    requests, exactly as in the paper.
    """
    from ..core.fingerprint import fingerprint
    from ..core.identify import Occurrence, SimilarSubexpression

    table = {}
    memo = {}
    for qi, r in enumerate(requests):
        node = r.chain
        while node is not None:
            psi = fingerprint(node, memo)
            se = table.get(psi)
            if se is None:
                se = table[psi] = SimilarSubexpression(psi=psi)
            se.occurrences.append(Occurrence(qi, node))
            node = node.prev

    out = [se for se in table.values()
           if se.m >= k and len(se.query_indices) >= 2]
    out.sort(key=lambda s: (-s.occurrences[0].node.n_tokens, s.psi))
    return out

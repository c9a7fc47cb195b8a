# The paper's primary contribution: cache-based multi-query optimization.
# Generic machinery (fingerprints -> SEs -> CEs -> MCKP -> rewrite), used
# by both the relational engine (faithful repro) and the LLM serving
# layer (beyond-paper prefix-cache MQO).
from .cache import (CacheEntry, CacheManager, CacheStats,
                    CacheTransaction)
from .candidates import KnapsackItem, generate_knapsack_items
from .costmodel import CostModel, price_ce, price_ces, price_resident_ce
from .covering import (CoveringExpression, build_covering_expression,
                       build_covering_expressions)
from .faults import (FAULT_POINTS, DegradationEvent, FaultConfig,
                     FaultInjector, InjectedFault, TransientError)
from .fingerprint import (Fingerprint, all_fingerprints, fingerprint,
                          fingerprint_set, node_id)
from .identify import (Occurrence, SimilarSubexpression,
                       identify_similar_subexpressions)
from .mckp import MCKPSolution, solve_bruteforce, solve_mckp
from .memory import (Journal, MemoryEntry, MemoryManager, MemoryPool,
                     PoolStats)
from .optimizer import MQOReport, MultiQueryOptimizer, OptimizedBatch
from .plan import PlanNode, contains_unfriendly, tree_depth, tree_size, walk
from .rewrite import RewrittenBatch, Rewriter, rewrite_batch

__all__ = [
    "CacheEntry", "CacheManager", "CacheStats", "CacheTransaction",
    "FAULT_POINTS", "DegradationEvent", "FaultConfig", "FaultInjector",
    "InjectedFault", "TransientError", "Journal", "KnapsackItem",
    "generate_knapsack_items", "CostModel", "price_ce", "price_ces",
    "price_resident_ce",
    "CoveringExpression", "build_covering_expression",
    "build_covering_expressions", "Fingerprint", "all_fingerprints",
    "fingerprint", "fingerprint_set", "node_id", "Occurrence",
    "SimilarSubexpression", "identify_similar_subexpressions",
    "MCKPSolution", "solve_bruteforce", "solve_mckp",
    "MemoryEntry", "MemoryManager", "MemoryPool", "PoolStats",
    "MQOReport",
    "MultiQueryOptimizer", "OptimizedBatch", "PlanNode",
    "contains_unfriendly", "tree_depth", "tree_size", "walk",
    "RewrittenBatch", "Rewriter", "rewrite_batch",
]

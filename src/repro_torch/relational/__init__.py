# SparkSQL-analog relational substrate: columnar tables over torch
# tensors, the fluent lazy Relation frontend compiled through a canonical
# plan IR, logical plans, Catalyst-like local optimization, cardinality
# stats, per-operator execution on the session's device, the MQO
# integration and the online QueryService front-end (continuous
# submission + micro-batch MQO windows).  The asyncio front of the JAX
# package is not ported yet.
from . import expr, logical
from .api import ColExpr, Pred, Relation, as_expr, c, col
from .canonical import (FALSE, canonicalize_expr, canonicalize_plan,
                        format_plan)
from .datagen import (generate_columns, make_storage, people_schema,
                      synthetic_schema)
from .executor import BatchResult, QueryResult, Session
from .fuse import FusedPipeline, fuse_plan, unfuse_plan
from .observe import (EXPLAIN_CE_KEYS, EXPLAIN_DONE_KEYS,
                      EXPLAIN_DONE_OPTIONAL_KEYS, EXPLAIN_FAILED_KEYS,
                      ExplainCE, ExplainReport, Telemetry,
                      build_metrics_report)
from .partition import (CePartition, PartitionInfo, PartitionedCePlan,
                        Partitioning, make_ce_partitioner, partition_table,
                        prune_parts)
from .physical import (CEMaterializationError, ExecContext, ExecMetrics,
                       TableStorage, execute)
from .rewriter import RelationalRewriter, make_ce_transform
from .rules import optimize_single
from .schema import F32, I32, I64, STR, ColType, Schema, Table, next_pow2
from .service import (ExecutionConfig, MemoryConfig, MqoConfig,
                      QueryError, QueryHandle, QueryService,
                      ResilienceConfig, SessionConfig, WindowState)
from .stats import (RelationalCostModel, StatsRegistry, build_table_stats,
                    required_columns, selectivity)

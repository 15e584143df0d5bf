"""MV4PG core on PyTorch: property-graph store, views, templated maintenance,
optimizer (the port of ``repro.core``)."""
from repro_torch.core.schema import GraphSchema, LabelRegistry, NO_LABEL
from repro_torch.core.graph import (
    PropertyGraph, GraphBuilder, LabelEpochs, WriteBatch, create_edge,
    create_node, delete_edge, delete_node, edge_pred_mask, find_node,
    node_pred_mask, set_edge_props, set_node_props,
)
from repro_torch.core.pattern import (
    Direction, FreshnessPolicy, NodePat, PathPattern, PropPred, Query,
    QueryFingerprint, RelPat, ViewDef, normalize_preds, preds_imply,
)
from repro_torch.core.parser import (
    canonicalize_query, parse_query, parse_view, query_fingerprint,
)
from repro_torch.core.executor import (
    ExecConfig, ExecEngine, Metrics, PairRows, PathExecutor, ReachResult,
)
from repro_torch.core.plan import CompiledPlan, QueryPlanner
from repro_torch.core.maintenance import ViewTemplates, MaintTemplate
from repro_torch.core.views import (
    BatchResult, GraphSession, MaterializedView, ViewHandle, ViewStats,
    ViewStatus,
)
from repro_torch.core.optimizer import optimize_query

__all__ = [
    "GraphSchema", "LabelRegistry", "NO_LABEL",
    "PropertyGraph", "GraphBuilder", "LabelEpochs", "WriteBatch",
    "create_edge", "create_node", "delete_edge", "delete_node", "find_node",
    "edge_pred_mask", "node_pred_mask", "set_edge_props", "set_node_props",
    "Direction", "FreshnessPolicy", "NodePat", "PathPattern", "PropPred",
    "Query", "QueryFingerprint", "RelPat", "ViewDef", "normalize_preds",
    "preds_imply",
    "canonicalize_query", "parse_query", "parse_view", "query_fingerprint",
    "ExecConfig", "ExecEngine", "Metrics", "PairRows", "PathExecutor",
    "ReachResult",
    "CompiledPlan", "QueryPlanner",
    "ViewTemplates", "MaintTemplate",
    "BatchResult", "GraphSession", "MaterializedView", "ViewHandle",
    "ViewStats", "ViewStatus",
    "optimize_query",
]

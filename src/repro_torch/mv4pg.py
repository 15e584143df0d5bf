"""The blessed MV4PG public API, in one import (DESIGN.md §14).

    from repro_torch import mv4pg as pg

    sess = pg.GraphSession(graph, schema)          # on the card by default
    handle = sess.create_view("CREATE VIEW V AS (...) REFRESH DEFERRED")
    handle.stats().e_vl, handle.policy, handle.drain()
    rows = sess.query("MATCH (s:A)-[:x]->(d:B)").pairs()   # PairRows

    sub = handle.subgraph()          # maintained training substrate
    params, report = pg.train_on_view(sess, handle, pg.TrainConfig())
    eng = sess.serve()
    eng.register_embedder(pg.ViewEmbedder(sess, handle, params))
    emb = eng.result(eng.submit_embed(handle.name, node_ids))

Everything re-exported here is the stable surface; module paths under
``repro_torch.core``/``repro_torch.serve``/... remain importable but are not all
covered by the deprecation policy.  The names and ``__all__`` are the
reference package's (``repro.mv4pg``); each is the port's class.
"""
from repro_torch.core.executor import ExecConfig, Metrics, PairRows, ReachResult
from repro_torch.core.graph import GraphBuilder, PropertyGraph, WriteBatch
from repro_torch.core.parser import parse_query, parse_view
from repro_torch.core.pattern import FreshnessPolicy, Query, ViewDef
from repro_torch.core.schema import GraphSchema
from repro_torch.core.views import (
    BatchResult, GraphSession, ViewHandle, ViewStatus,
)
from repro_torch.graphops.sampler import NeighborSampler, SampledSubgraph
from repro_torch.graphops.view_subgraph import ViewSubgraph, view_to_graphbatch
from repro_torch.launch.gnn import (
    TrainConfig, TrainReport, ViewEmbedder, embed_on_view, train_on_view,
)
from repro_torch.models.gnn.graphdata import GraphBatch
from repro_torch.serve.engine import (
    EmbedResult, ServeConfig, ServeEngine, ServeStats, ServeTicket,
)

__all__ = [
    # session + graph
    "GraphSession", "GraphSchema", "GraphBuilder", "PropertyGraph",
    "WriteBatch", "BatchResult", "ExecConfig", "Metrics",
    # queries + views
    "Query", "ViewDef", "FreshnessPolicy", "parse_query", "parse_view",
    "ReachResult", "PairRows", "ViewHandle", "ViewStatus",
    # training substrate
    "ViewSubgraph", "view_to_graphbatch", "NeighborSampler",
    "SampledSubgraph", "GraphBatch", "TrainConfig", "TrainReport",
    "train_on_view", "embed_on_view", "ViewEmbedder",
    # serving
    "ServeEngine", "ServeConfig", "ServeStats", "ServeTicket", "EmbedResult",
]

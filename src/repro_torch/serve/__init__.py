"""Serving runtime: ``repro_torch.serve.engine``, the graph-query serve
engine (the port of ``repro.serve.engine``): a continuous-batching scheduler
with label-scoped write fences, admission deadlines, adaptive windows,
cross-window result memoization and cross-fingerprint structural sharing."""
from repro_torch.serve.engine import (
    EmbedResult, FenceScope, ServeConfig, ServeEngine, ServeStats,
    ServeTicket,
)

__all__ = ["EmbedResult", "FenceScope", "ServeConfig", "ServeEngine",
           "ServeStats", "ServeTicket"]

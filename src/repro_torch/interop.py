"""Rebuild port state from plain arrays (no JAX involved).

A graph or schema described by numpy arrays and label lists — for example
the fields of a graph built by the reference package, pulled to the host —
becomes the port's :class:`~repro_torch.core.graph.PropertyGraph` /
:class:`~repro_torch.core.schema.GraphSchema`, so both packages can run on
identical state.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.graph import PropertyGraph
from repro_torch.core.schema import GraphSchema
from repro_torch.utils import resolve_device
from repro_torch.utils.device import DeviceLike

_COLUMNS = {
    "node_label": np.int32, "node_key": np.int32, "node_alive": bool,
    "edge_src": np.int32, "edge_dst": np.int32, "edge_label": np.int32,
    "edge_alive": bool, "edge_weight": np.int32,
}


def graph_from_arrays(arrays: Dict[str, object],
                      device: DeviceLike = None) -> PropertyGraph:
    """``arrays`` maps each :class:`PropertyGraph` field name to a numpy
    array; ``node_props`` / ``edge_props`` map property names to int32
    columns."""
    dev = resolve_device(device)

    def put(a, dtype) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)  # a copy

    cols = {k: put(arrays[k], dt) for k, dt in _COLUMNS.items()}
    props = {kind: {name: put(col, np.int32)
                    for name, col in dict(arrays.get(kind, {})).items()}
             for kind in ("node_props", "edge_props")}
    return PropertyGraph(**cols, **props)


def schema_from_labels(node_labels: Sequence[str], edge_labels: Sequence[str],
                       view_labels: Iterable[str] = ()) -> GraphSchema:
    """A schema interning the labels in id order; ``view_labels`` (a subset
    of ``edge_labels``) are marked as view-owned."""
    schema = GraphSchema()
    for name in node_labels:
        schema.node_labels.intern(name)
    for name in edge_labels:
        schema.edge_labels.intern(name)
    for name in view_labels:
        schema.register_view_label(name)
    return schema

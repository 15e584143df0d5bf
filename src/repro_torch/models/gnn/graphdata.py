"""Batched graph containers with static, padded shapes.

``GraphBatch`` holds one padded graph (or sampled subgraph) as tensors on
one device: node features and masks, a COO edge list with its padding mask,
and optional labels and edge weights (a view's path counts).
:func:`pad_graph` builds one from host arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.utils import resolve_device, round_up
from repro_torch.utils.device import DeviceLike


@dataclass(frozen=True)
class GraphBatch:
    node_feat: torch.Tensor          # [N, Df] float or [N] int (atom types)
    edge_src: torch.Tensor           # [E] int32
    edge_dst: torch.Tensor           # [E] int32
    edge_mask: torch.Tensor          # [E] bool (padding)
    node_mask: torch.Tensor          # [N] bool
    graph_id: torch.Tensor           # [N] int32 (0 for single-graph batches)
    positions: Optional[torch.Tensor] = None    # [N, 3] for geometric models
    labels: Optional[torch.Tensor] = None       # [N] or [G]
    edge_weight: Optional[torch.Tensor] = None  # [E] float32 (path counts)

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_src.shape[0]

    @property
    def n_graphs(self) -> int:
        return 1


def pad_graph(node_feat, edge_src, edge_dst, *, positions=None, labels=None,
              graph_id=None, edge_weight=None, node_pad=128, edge_pad=128,
              device: DeviceLike = None) -> GraphBatch:
    """Pad host arrays to multiples of ``node_pad`` / ``edge_pad`` and put
    them on ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    n = node_feat.shape[0]
    e = edge_src.shape[0]
    N = round_up(max(n, 1), node_pad)
    E = round_up(max(e, 1), edge_pad)

    def pad(a, L, fill=0):
        a = np.asarray(a)
        out = np.full((L,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return torch.from_numpy(out).to(dev)

    return GraphBatch(
        node_feat=pad(node_feat, N),
        edge_src=pad(np.asarray(edge_src, np.int32), E),
        edge_dst=pad(np.asarray(edge_dst, np.int32), E),
        edge_mask=pad(np.ones(e, bool), E, False),
        node_mask=pad(np.ones(n, bool), N, False),
        graph_id=pad(np.zeros(n, np.int32) if graph_id is None
                     else np.asarray(graph_id, np.int32), N),
        positions=None if positions is None else pad(
            np.asarray(positions, np.float32), N),
        labels=None if labels is None else pad(np.asarray(labels), N),
        edge_weight=None if edge_weight is None else pad(
            np.asarray(edge_weight, np.float32), E),
    )

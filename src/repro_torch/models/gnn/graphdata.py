"""Batched graph containers with static, padded shapes.

``GraphBatch`` holds one padded graph (or sampled subgraph) as tensors on
one device: node features and masks, a COO edge list with its padding mask,
and optional labels and edge weights (a view's path counts).
:func:`pad_graph` builds one from host arrays, :func:`random_graph_batch`
draws one from a ``torch.Generator``, and :func:`build_triplets` derives
DimeNet's 2-hop edge pairs from a COO edge list.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

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


@dataclass(frozen=True)
class PartitionedBatch(GraphBatch):
    """This rank's blocks of a batch whose nodes, edges (and DimeNet's
    triplets) are split by rows over a rank mesh, with the
    ``graphops.distributed.RowPartition`` that reads and sums across
    them."""
    partition: Optional[object] = None


def partitioned(gb: GraphBatch, partition) -> PartitionedBatch:
    return PartitionedBatch(**{f.name: getattr(gb, f.name)
                               for f in dataclasses.fields(GraphBatch)},
                            partition=partition)


def rows(gb: GraphBatch, x: torch.Tensor, idx: torch.Tensor
         ) -> torch.Tensor:
    """``x[idx]`` for a node- or edge-indexed ``x`` (global ``idx``)."""
    if getattr(gb, "partition", None) is not None:
        return gb.partition.gather(x, idx)
    out = torch.index_select(x, 0, idx.reshape(-1).long())
    return out.reshape(*idx.shape, *x.shape[1:])


def scatter(gb: GraphBatch, data: torch.Tensor, ids: torch.Tensor,
            n: int) -> torch.Tensor:
    """The segment sum of ``data`` into ``n`` node or edge rows (this
    rank's ``n`` rows of a partitioned batch)."""
    if getattr(gb, "partition", None) is not None:
        return gb.partition.scatter(data, ids, n)
    out = data.new_zeros((n,) + tuple(data.shape[1:]))
    return out.index_add(0, ids.long(), data)


def pool(gb: GraphBatch, data: torch.Tensor, ids: torch.Tensor, n: int
         ) -> torch.Tensor:
    """The segment sum of node rows into ``n`` graphs (over every rank's
    rows of a partitioned batch)."""
    if getattr(gb, "partition", None) is not None:
        return gb.partition.pool(data, ids, n)
    out = data.new_zeros((n,) + tuple(data.shape[1:]))
    return out.index_add(0, ids.long(), data)


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


def build_triplets(edge_src: np.ndarray, edge_dst: np.ndarray,
                   max_triplets: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (e_kj, e_ji) edge pairs sharing middle node j with k != i.

    Returns (t_in, t_out, mask): indices into the edge list such that
    edge t_in = (k -> j) feeds edge t_out = (j -> i).  This is the 2-hop
    path view DimeNet aggregates angular features over.
    """
    edge_src = np.asarray(edge_src)
    edge_dst = np.asarray(edge_dst)
    E = edge_src.shape[0]
    by_dst: dict[int, list[int]] = {}
    for e in range(E):
        by_dst.setdefault(int(edge_dst[e]), []).append(e)
    t_in, t_out = [], []
    for e_out in range(E):
        j = int(edge_src[e_out])
        i = int(edge_dst[e_out])
        for e_in in by_dst.get(j, ()):
            if int(edge_src[e_in]) != i:          # no immediate backtrack
                t_in.append(e_in)
                t_out.append(e_out)
    t_in = np.asarray(t_in, np.int32)
    t_out = np.asarray(t_out, np.int32)
    T = t_in.shape[0]
    cap = max_triplets or round_up(max(T, 1), 128)
    mask = np.zeros(cap, bool)
    mask[: min(T, cap)] = True
    out_in = np.zeros(cap, np.int32)
    out_out = np.zeros(cap, np.int32)
    out_in[: min(T, cap)] = t_in[:cap]
    out_out[: min(T, cap)] = t_out[:cap]
    return out_in, out_out, mask


def random_graph_batch(gen: torch.Generator, n_nodes: int, n_edges: int,
                       d_feat: int, *, geometric: bool = False,
                       n_labels: int = 8, batch: int = 1,
                       device: DeviceLike = None) -> GraphBatch:
    """Synthetic batch for smoke runs, drawn on ``gen``'s device and put on
    ``device``; no padding (every edge and node mask is true)."""
    dev = resolve_device(device)
    g = gen.device

    def ints(hi, n):
        return torch.randint(0, hi, (n,), generator=gen, device=g,
                             dtype=torch.int32)

    src, dst = ints(n_nodes, n_edges), ints(n_nodes, n_edges)
    if geometric:
        feat = ints(5, n_nodes)
        pos = torch.randn((n_nodes, 3), generator=gen, device=g) * 2.0
    else:
        feat = torch.randn((n_nodes, d_feat), generator=gen, device=g)
        pos = None
    gid = (torch.arange(n_nodes, device=g) * batch // n_nodes).to(
        torch.int32)
    labels = ints(n_labels, n_nodes)
    return GraphBatch(
        node_feat=feat.to(dev), edge_src=src.to(dev), edge_dst=dst.to(dev),
        edge_mask=torch.ones(n_edges, dtype=torch.bool, device=dev),
        node_mask=torch.ones(n_nodes, dtype=torch.bool, device=dev),
        graph_id=gid.to(dev), positions=None if pos is None else pos.to(dev),
        labels=labels.to(dev))

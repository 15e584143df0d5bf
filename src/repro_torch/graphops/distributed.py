"""Edge partitioning for sharded execution, and the dst-partitioned
aggregation over a rank mesh.

Sharded plans split node columns into ``n_shards`` equal ranges and give
each shard the edges whose **scatter-side** endpoint it owns, so a hop
gathers from the full (all-gathered) frontier and scatters into local
columns only: no cross-shard scatter exists.  Maintenance routing anchors
each label's delta sweeps to an owner shard.  The partitioners are numpy,
on the host.

The GNN layers use the same scheme over a rank mesh
(:func:`dst_partitioned_aggregate`): nodes shard over the mesh axes (row
partition), edges are pre-partitioned by destination owner, and each rank
all-gathers node features once a layer, gathers sources locally and
segment-reduces into its own node range only: no cross-rank scatter and
no reduction collective.  Its backward is the gather's reduce-scatter.

:class:`RowPartition` is the pair the molecular models (DimeNet, NequIP,
MACE) run on when nodes, edges and triplets are all split in contiguous
blocks over the mesh axes (the reference's cells shard them so and leave
the rest to SPMD): a row read all-gathers the rows over the axes and
indexes them; a scatter sums the local rows into a full buffer and
reduce-scatters it to the rank's block; a pool (per-graph sums) is a
``psum``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import Mesh, axis_product


def flat_axis_index(axes: Sequence[str], mesh: Mesh) -> int:
    """This rank's linear index over a tuple of mesh axes (row-major)."""
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + C.axis_index(a, mesh)
    return idx


def all_gather_axes(x: torch.Tensor, axes: Sequence[str], mesh: Mesh,
                    axis: int = 0) -> torch.Tensor:
    return C.all_gather(x, tuple(axes), mesh, axis=axis)


def dst_partitioned_aggregate(h_l: torch.Tensor, src_l: torch.Tensor,
                              dst_l: torch.Tensor, mask_l: torch.Tensor,
                              msg_and_reduce: Callable, mesh: Mesh,
                              axes: Sequence[str]):
    """This rank's part of a sharded gather-aggregate.

    ``h_l`` [n_loc, D]: this rank's node rows; ``src_l``, ``dst_l``,
    ``mask_l``: its edges (global ids, partitioned by destination owner).
    ``msg_and_reduce(h_full, src_l, dst_local, mask_l, n_loc)`` runs on
    this rank alone; its result is this rank's node rows."""
    n_loc = h_l.shape[0]
    h_full = all_gather_axes(h_l, axes, mesh, axis=0)          # [N, D]
    offset = flat_axis_index(axes, mesh) * n_loc
    return msg_and_reduce(h_full, src_l, dst_l - offset, mask_l, n_loc)


@dataclass(frozen=True)
class RowPartition:
    """Row-split node- and edge-indexed tensors over ``axes`` of a rank
    mesh: this rank holds rows [i * n, (i + 1) * n) of each, i its flat
    index over ``axes``; indices into them are global."""
    mesh: Mesh
    axes: Tuple[str, ...]

    def gather(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``full[idx]`` from this rank's rows ``x`` of ``full``."""
        full = all_gather_axes(x, self.axes, self.mesh, axis=0)
        out = torch.index_select(full, 0, idx.reshape(-1).long())
        return out.reshape(*idx.shape, *x.shape[1:])

    def scatter(self, data: torch.Tensor, ids: torch.Tensor, n_local: int
                ) -> torch.Tensor:
        """This rank's rows of the segment sum of every rank's ``data``
        into ``n_local`` rows a rank."""
        n = n_local * axis_product(self.mesh, self.axes)
        full = data.new_zeros((n,) + tuple(data.shape[1:])).index_add(
            0, ids.long(), data)
        return C.psum_scatter(full, self.axes, self.mesh, axis=0)

    def pool(self, data: torch.Tensor, ids: torch.Tensor, n: int
             ) -> torch.Tensor:
        """The segment sum into ``n`` segments over every rank's rows
        (equal on every rank)."""
        out = data.new_zeros((n,) + tuple(data.shape[1:])).index_add(
            0, ids.long(), data)
        return C.psum(out, self.axes, self.mesh)


def shard_owner(label_id: int, n_shards: int) -> int:
    """Deterministic owner shard for a label's maintenance routing.

    Edge *data* is dst-partitioned across every shard (see
    :func:`partition_hop_edges`); the owner shard is the scheduling anchor:
    delta sweeps and drain batches for a label group under its owner so
    maintenance work spreads round-robin over the shards."""
    return int(label_id) % max(int(n_shards), 1)


def partition_hop_edges(gather_ids: np.ndarray, scatter_ids: np.ndarray,
                        weights: np.ndarray, n_pad: int, n_shards: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray, np.ndarray]:
    """Dst-partition of one hop's compact edge slice.

    Edges go to the owner of their scatter-side endpoint (the hop's
    traversal destination; callers pass ``(dst, src)`` swapped for reverse
    hops).  Returns stacked per-shard arrays, padded to a uniform per-shard
    width (padding slots are masked off — exact no-ops):

      * ``a``        [D, Ep]  gather-side endpoint, **global** node id
      * ``b_local``  [D, Ep]  scatter-side endpoint minus the shard offset,
                              in ``[0, n_loc)``
      * ``w``        [D, Ep]  edge weights
      * ``mask``     [D, Ep]  real-edge mask
      * ``deg``      [D, N_pad] partial degree by gather-side endpoint over
                              the shard's own edges; the partials sum to
                              the single-device degree vector exactly.

    ``n_pad`` is the node-column capacity padded to a multiple of
    ``n_shards`` (``n_loc = n_pad // n_shards``).
    """
    gather_ids = np.asarray(gather_ids, np.int32)
    scatter_ids = np.asarray(scatter_ids, np.int32)
    weights = np.asarray(weights, np.int32)
    if n_pad % n_shards != 0:
        raise ValueError(f"n_pad={n_pad} not a multiple of n_shards={n_shards}")
    n_loc = n_pad // n_shards
    owner = np.minimum(scatter_ids // n_loc, n_shards - 1)
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n_shards)
    width = max(int(counts.max()) if counts.size else 0, 1)
    a = np.zeros((n_shards, width), np.int32)
    b_local = np.zeros((n_shards, width), np.int32)
    w = np.zeros((n_shards, width), np.int32)
    mask = np.zeros((n_shards, width), bool)
    deg = np.zeros((n_shards, n_pad), np.int32)
    start = 0
    for s in range(n_shards):
        c = int(counts[s])
        sl = order[start:start + c]
        a[s, :c] = gather_ids[sl]
        b_local[s, :c] = scatter_ids[sl] - s * n_loc
        w[s, :c] = weights[sl]
        mask[s, :c] = True
        np.add.at(deg[s], gather_ids[sl], 1)
        start += c
    return a, b_local, w, mask, deg


def partition_edges_by_dst(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                           n_shards: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Order edges so shard i holds edges whose dst is in node shard i,
    padded per shard to a uniform length (returns perm, mask, counts)."""
    n_loc = n_nodes // n_shards
    owner = np.minimum(dst // n_loc, n_shards - 1)
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n_shards)
    width = int(counts.max()) if counts.size else 1
    E_pad = width * n_shards
    perm = np.zeros(E_pad, np.int64)
    mask = np.zeros(E_pad, bool)
    start = 0
    for s in range(n_shards):
        c = counts[s]
        sl = order[start:start + c]
        perm[s * width: s * width + c] = sl
        mask[s * width: s * width + c] = True
        start += c
    return perm, mask, counts

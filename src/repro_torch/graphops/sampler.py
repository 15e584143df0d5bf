"""Fanout neighbor sampler (GraphSAGE-style) for minibatch_lg training.

Host-side CSR sampling: for each seed node, sample up to ``fanout[0]``
neighbors, then ``fanout[1]`` neighbors of those, etc.; returns the induced
padded subgraph with relabeled node ids.  Deterministic per (seed, step).

The per-layer fanout step is fully vectorized: one ``rng.permuted`` over the
frontier's padded neighbor blocks yields a uniform without-replacement draw
per node, and newly discovered nodes are relabeled in sorted-unique order —
no per-node Python loop, no dict probes.  ``_sample_loop`` keeps the
original per-node loop as the differential/microbench reference twin.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np

from repro_torch.graphops.csr import build_csr


class SampledSubgraph(NamedTuple):
    """One sampled minibatch subgraph.

    A ``NamedTuple`` so the legacy 4-tuple unpacking of
    :meth:`NeighborSampler.sample` keeps working unchanged.
    """

    node_ids: np.ndarray        # [n] original ids (seeds first)
    edge_src: np.ndarray        # [e] subgraph-local src (toward seeds)
    edge_dst: np.ndarray        # [e] subgraph-local dst
    seed_positions: np.ndarray  # [s] seed positions within node_ids

    @property
    def n_nodes(self) -> int:
        return int(self.node_ids.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edge_src.shape[0])


class NeighborSampler:
    def __init__(self, src: np.ndarray, dst: np.ndarray, num_nodes: int):
        self.indptr, self.nbrs, _ = build_csr(dst, src, num_nodes)
        # CSR over incoming edges: sampling neighbors that MESSAGE INTO seeds
        self.num_nodes = num_nodes

    @classmethod
    def from_csr(cls, indptr: np.ndarray, nbrs: np.ndarray,
                 num_nodes: int) -> "NeighborSampler":
        """Wrap an existing incoming-edge CSR without re-sorting the edges
        (the :class:`~repro_torch.graphops.view_subgraph.ViewSubgraph` hand-off)."""
        self = cls.__new__(cls)
        self.indptr = np.asarray(indptr, np.int64)
        self.nbrs = np.asarray(nbrs)
        self.num_nodes = int(num_nodes)
        return self

    def sample(self, seeds: np.ndarray, fanout: Sequence[int], seed: int = 0
               ) -> SampledSubgraph:
        """Returns (node_ids, sub_src, sub_dst, seed_positions).

        node_ids: original ids of subgraph nodes (seeds first);
        sub_src/sub_dst: edges in subgraph-local ids (src -> dst toward
        seeds).  ``seeds`` must be unique.  Deterministic per ``seed``: the
        layer draws consume the generator sequentially, so layer ``i`` is a
        pure function of (seed, layers < i).
        """
        rng = np.random.default_rng(seed)
        seeds = np.asarray(seeds, np.int64)
        loc = np.full(self.num_nodes, -1, np.int64)
        loc[seeds] = np.arange(seeds.shape[0])
        node_chunks = [seeds]
        n_nodes = int(seeds.shape[0])
        e_src: list = []
        e_dst: list = []
        frontier = seeds
        for f in fanout:
            if frontier.size == 0:
                break
            deg = self.indptr[frontier + 1] - self.indptr[frontier]
            act = deg > 0
            fa, da = frontier[act], deg[act]
            if fa.size == 0:
                break
            w = int(da.max())
            # one uniform permutation of each padded neighbor block: the
            # first min(f, deg) in-degree-valid entries of each row are a
            # uniform without-replacement draw from that node's neighbors
            perm = rng.permuted(
                np.repeat(np.arange(w, dtype=np.int64)[None, :],
                          fa.shape[0], axis=0), axis=1)
            valid = perm < da[:, None]
            rank = np.cumsum(valid, axis=1) - 1
            sel = valid & (rank < np.minimum(int(f), da)[:, None])
            rows = np.broadcast_to(
                np.arange(fa.shape[0])[:, None], perm.shape)[sel]
            u = self.nbrs[self.indptr[fa][rows] + perm[sel]]
            v = fa[rows]
            # sorted-unique relabeling of newly discovered nodes
            uniq = np.unique(u)
            new = uniq[loc[uniq] < 0]
            loc[new] = n_nodes + np.arange(new.shape[0])
            n_nodes += int(new.shape[0])
            node_chunks.append(new)
            e_src.append(loc[u].astype(np.int32))
            e_dst.append(loc[v].astype(np.int32))
            frontier = new
        return SampledSubgraph(
            np.concatenate(node_chunks),
            (np.concatenate(e_src) if e_src else np.zeros(0, np.int32)),
            (np.concatenate(e_dst) if e_dst else np.zeros(0, np.int32)),
            np.arange(seeds.shape[0], dtype=np.int32))

    def _sample_loop(self, seeds: np.ndarray, fanout: Sequence[int],
                     seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
        """The original per-node dict-loop sampler.  Kept as the reference
        twin: differential tests check the vectorized path draws the same
        *kind* of subgraph (edge validity, per-node counts), and the gnn
        bench asserts the vectorized path is faster."""
        rng = np.random.default_rng(seed)
        frontier = np.asarray(seeds, np.int64)
        id_map = {int(v): i for i, v in enumerate(frontier)}
        nodes = list(map(int, frontier))
        e_src: list = []
        e_dst: list = []
        for f in fanout:
            nxt: list = []
            for v in frontier:
                lo, hi = self.indptr[v], self.indptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                k = min(f, deg)
                pick = rng.choice(deg, size=k, replace=False) + lo
                for u in self.nbrs[pick]:
                    u = int(u)
                    if u not in id_map:
                        id_map[u] = len(nodes)
                        nodes.append(u)
                        nxt.append(u)
                    e_src.append(id_map[u])
                    e_dst.append(id_map[int(v)])
            frontier = np.asarray(nxt, np.int64)
            if frontier.size == 0:
                break
        return (np.asarray(nodes, np.int64), np.asarray(e_src, np.int32),
                np.asarray(e_dst, np.int32),
                np.arange(len(seeds), dtype=np.int32))


def max_subgraph_size(batch_nodes: int, fanout: Sequence[int]
                      ) -> Tuple[int, int]:
    """Worst-case (nodes, edges) for padding the sampled subgraph."""
    nodes = batch_nodes
    edges = 0
    layer = batch_nodes
    for f in fanout:
        layer = layer * f
        nodes += layer
        edges += layer
    return nodes, edges

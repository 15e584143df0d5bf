"""Plain graph state and path evaluation: what a read or a view must return.

A path is the structured form that a configuration keeps beside each
Cypher text::

    {"start": "Comment",
     "steps": [{"rel": "replyOf", "dir": "out", "min": 1, "max": null,
                "node": "Post"}]}

Semantics (MV4PG, paper section IV): a path whose hop ranges are all
finite counts walks, ``sum_{k=min..max} F A^k`` per step, then keeps the
rows' columns whose node is alive and carries the step's node label; a
path with an unbounded step (``"max": null``) is evaluated as
reachability (set semantics), ``F A^min`` and then the closure.  Counts
are int64 here; the port stores int32.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class GraphState:
    """Nodes and a multiset of labelled edges, as NumPy arrays.  Node ids
    are positions; an edge's id is its creation index (never reused)."""

    def __init__(self, node_labels: Sequence[str], node_label: np.ndarray,
                 edge_labels: Sequence[str], src: np.ndarray,
                 dst: np.ndarray, edge_label: np.ndarray):
        self.node_labels = tuple(node_labels)
        self.edge_labels = tuple(edge_labels)
        self.node_label = np.asarray(node_label, np.int32).copy()
        self.label_of_node = self.node_label.copy()   # kept across deletes
        n_e = int(np.asarray(src).shape[0])
        cap = max(2 * n_e, 1024)
        self.src = np.zeros(cap, np.int64)
        self.dst = np.zeros(cap, np.int64)
        self.lab = np.zeros(cap, np.int32)
        self.alive = np.zeros(cap, bool)
        self.src[:n_e], self.dst[:n_e] = src, dst
        self.lab[:n_e], self.alive[:n_e] = edge_label, True
        self.n_edges = n_e
        self.version = 0

    @classmethod
    def from_data(cls, data: dict) -> "GraphState":
        return cls(data["node_labels"], data["node_label"],
                   data["edge_labels"], data["src"], data["dst"],
                   data["edge_label"])

    @property
    def n_nodes(self) -> int:
        return int(self.node_label.shape[0])

    def node_label_id(self, name: str) -> int:
        return self.node_labels.index(name)

    def edge_label_id(self, name: str) -> int:
        return self.edge_labels.index(name)

    def alive_nodes(self, label: Optional[str] = None) -> np.ndarray:
        m = self.node_label >= 0
        if label is not None:
            m &= self.node_label == self.node_label_id(label)
        return np.flatnonzero(m)

    # -- writes ---------------------------------------------------------

    def create_edge(self, s: int, d: int, label: str) -> int:
        if self.node_label[s] < 0 or self.node_label[d] < 0:
            raise ValueError(f"edge {s}->{d} has a dead endpoint")
        if self.n_edges == self.src.shape[0]:
            for f in ("src", "dst", "lab", "alive"):
                a = getattr(self, f)
                setattr(self, f, np.concatenate([a, np.zeros_like(a)]))
        h = self.n_edges
        self.src[h], self.dst[h] = s, d
        self.lab[h], self.alive[h] = self.edge_label_id(label), True
        self.n_edges += 1
        self.version += 1
        return h

    def delete_edge(self, h: int) -> None:
        if not self.alive[h]:
            raise ValueError(f"edge {h} is not alive")
        self.alive[h] = False
        self.version += 1

    def delete_node(self, n: int) -> List[int]:
        """Kill node ``n`` and its alive incident edges; returns their ids."""
        e = slice(0, self.n_edges)
        inc = np.flatnonzero(self.alive[e] & ((self.src[e] == n)
                                              | (self.dst[e] == n)))
        self.alive[inc] = False
        self.node_label[n] = -1
        self.version += 1
        return [int(h) for h in inc]

    def create_node(self, n: int) -> None:
        if self.node_label[n] >= 0:
            raise ValueError(f"node {n} is alive")
        self.node_label[n] = self.label_of_node[n]
        self.version += 1

    def apply(self, ops) -> List[int]:
        """Apply one fence's ops (``("create_edge", s, d, label)``,
        ``("delete_edge", id)``, ``("delete_node", n)``,
        ``("create_node", n)``); returns the ids of the edges created."""
        created = []
        for op in ops:
            if op[0] == "create_edge":
                created.append(self.create_edge(op[1], op[2], op[3]))
            elif op[0] == "delete_edge":
                self.delete_edge(op[1])
            elif op[0] == "delete_node":
                self.delete_node(op[1])
            elif op[0] == "create_node":
                self.create_node(op[1])
            else:
                raise ValueError(f"unknown write op {op[0]!r}")
        return created

    def edge(self, h: int) -> Tuple[int, int, str]:
        return (int(self.src[h]), int(self.dst[h]),
                self.edge_labels[int(self.lab[h])])

    def edges_of(self, label: str) -> np.ndarray:
        e = slice(0, self.n_edges)
        return np.flatnonzero(self.alive[e]
                              & (self.lab[e] == self.edge_label_id(label)))


class Evaluator:
    """Evaluates paths over one :class:`GraphState` on ``device``, in
    blocks of source rows; edge slices are cached per state version."""

    def __init__(self, state: GraphState, device, block: int = 512):
        self.state = state
        self.device = torch.device(device)
        self.block = block
        self._cache: Dict[tuple, tuple] = {}

    def _edges(self, label: str):
        key = (label, self.state.version)
        ent = self._cache.get(key)
        if ent is None:
            if len(self._cache) > 64:
                self._cache.clear()
            h = self.state.edges_of(label)
            ent = (torch.from_numpy(self.state.src[h]).to(self.device),
                   torch.from_numpy(self.state.dst[h]).to(self.device))
            self._cache[key] = ent
        return ent

    def _node_mask(self, label: Optional[str]) -> torch.Tensor:
        lab = self.state.node_label
        m = lab >= 0
        if label is not None:
            m = m & (lab == self.state.node_label_id(label))
        return torch.from_numpy(m).to(self.device)

    def _hop(self, F: torch.Tensor, step: dict) -> torch.Tensor:
        s, d = self._edges(step["rel"])
        out = torch.zeros(F.shape, dtype=torch.int64, device=F.device)
        Fi = F.to(torch.int64)
        if step["dir"] in ("out", "both"):
            out.index_add_(1, d, Fi[:, s])
        if step["dir"] in ("in", "both"):
            out.index_add_(1, s, Fi[:, d])
        return out if F.dtype == torch.int64 else out > 0

    def _expand(self, F: torch.Tensor, step: dict) -> torch.Tensor:
        lo, hi = int(step["min"]), step["max"]
        if hi is not None:
            acc = F.clone() if lo == 0 else torch.zeros_like(F)
            cur = F
            for k in range(1, int(hi) + 1):
                cur = self._hop(cur, step)
                if k >= lo:
                    acc = acc + cur if F.dtype == torch.int64 else acc | cur
            return acc
        cur = F
        for _ in range(lo):
            cur = self._hop(cur, step)
        reach = frontier = cur
        while bool(frontier.any()):
            nxt = self._hop(frontier, step)
            frontier = nxt & ~reach
            reach = reach | nxt
        return reach

    def rows(self, path: dict, sources: np.ndarray,
             counting: Optional[bool] = None):
        """Yield ``(sources_block, rows)`` with ``rows`` an int64 ``[b, n]``
        tensor on the device (0/1 under set semantics)."""
        if counting is None:
            counting = is_counting(path)
        n = self.state.n_nodes
        masks = [self._node_mask(st.get("node")) for st in path["steps"]]
        for b0 in range(0, len(sources), self.block):
            ids = np.asarray(sources[b0:b0 + self.block], np.int64)
            F = torch.zeros((len(ids), n),
                            dtype=torch.int64 if counting else torch.bool,
                            device=self.device)
            F[torch.arange(len(ids), device=self.device),
              torch.from_numpy(ids).to(self.device)] = 1
            for st, m in zip(path["steps"], masks):
                F = self._expand(F, st)
                F = F * m[None, :] if counting else F & m[None, :]
            yield ids, F.to(torch.int64)

    def pairs(self, path: dict, sources: np.ndarray):
        """Every reached ``(src, dst, count)`` of ``path`` from ``sources``,
        as NumPy arrays sorted by source (in the given order), then dst."""
        out_s, out_d, out_c = [], [], []
        for ids, R in self.rows(path, sources):
            r, c = torch.nonzero(R, as_tuple=True)
            out_s.append(ids[r.cpu().numpy()])
            out_d.append(c.cpu().numpy())
            out_c.append(R[r, c].cpu().numpy())
        if not out_s:
            z = np.zeros(0, np.int64)
            return z, z, z
        return (np.concatenate(out_s), np.concatenate(out_d),
                np.concatenate(out_c))


def is_counting(path: dict) -> bool:
    """Bag semantics unless some step is unbounded."""
    return all(st["max"] is not None for st in path["steps"])


def sparse_row(row) -> Tuple[np.ndarray, np.ndarray]:
    """A dense row (NumPy or tensor) as its nonzero columns and values."""
    row = np.asarray(row.cpu() if isinstance(row, torch.Tensor) else row)
    cols = np.flatnonzero(row)
    return cols.astype(np.int64), row[cols].astype(np.int64)

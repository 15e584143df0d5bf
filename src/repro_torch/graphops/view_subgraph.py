"""Materialized views as the GNN training substrate (DESIGN.md §14).

:class:`ViewSubgraph` exposes a view's *maintained* arena edge pairs as the
CSR that :class:`~repro_torch.graphops.sampler.NeighborSampler` and
:class:`~repro_torch.models.gnn.graphdata.GraphBatch` consume — without
re-extracting the subgraph from the base graph.  The view's host pair index
(``MaterializedView.pair_slot``), kept current by the §5 maintenance
machinery, *is* the edge list; a refresh is a staleness check, not a query.

Incremental refresh is keyed on label epochs: each constituent edge label
(the view's own label, plus any extra base labels) caches its (src, dst,
weight) slice under the label's
:class:`~repro_torch.core.graph.LabelEpochs` counter, and a refresh re-extracts
only the slices whose epoch moved — a write to an unrelated label costs one
integer comparison per label.  The merged CSR (and the sampler wrapping it)
rebuilds only when some slice actually changed.

Freshness composes with the view's declared policy: a refresh on a stale
``REFRESH DEFERRED`` view drains it first (same read-triggers-drain rule as
the query path), while a ``STALENESS n`` view within bound keeps serving the
stale-but-bounded subgraph — mid-training mutation semantics match what a
query over the view would see.

The CSR and the slices live on the host; every read of device state (the
graph's ``edge_alive`` / ``edge_weight`` / ``node_label`` columns and the
engine's per-label slices) goes through :func:`repro_torch.utils.host`.
Batches are built on the session's device.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.graphops.csr import build_csr
from repro_torch.graphops.sampler import NeighborSampler, SampledSubgraph
from repro_torch.models.gnn.graphdata import GraphBatch, pad_graph
from repro_torch.utils import host
from repro_torch.utils.device import DeviceLike

if TYPE_CHECKING:  # pragma: no cover - typing only (no runtime core import)
    from repro_torch.core.views import GraphSession, MaterializedView


#: structural feature width: [1, log1p(in_deg), log1p(out_deg)] + an 8-way
#: node-label one-hot bucket — deterministic, shape-stable across refreshes
FEAT_DIM = 3 + 8


class EdgeSlice(NamedTuple):
    """One label's compact COO slice (host arrays, CSR-merge input)."""

    src: np.ndarray       # [e] int64 arena node ids
    dst: np.ndarray       # [e] int64
    weight: np.ndarray    # [e] int64 path counts (1 for base labels)


def structural_features(ids: np.ndarray, in_deg: np.ndarray,
                        out_deg: np.ndarray, node_label: np.ndarray
                        ) -> np.ndarray:
    """Deterministic node features from subgraph structure + node labels."""
    n = ids.shape[0]
    feat = np.zeros((n, FEAT_DIM), np.float32)
    feat[:, 0] = 1.0
    feat[:, 1] = np.log1p(in_deg[ids])
    feat[:, 2] = np.log1p(out_deg[ids])
    feat[np.arange(n), 3 + (node_label[ids] % 8)] = 1.0
    return feat


def build_graphbatch(src: np.ndarray, dst: np.ndarray, *,
                     node_label: np.ndarray, num_nodes: int,
                     weight: Optional[np.ndarray] = None,
                     node_pad: int = 128, edge_pad: int = 128,
                     device: DeviceLike = None) -> GraphBatch:
    """Canonical COO -> :class:`GraphBatch`: sorted-unique local relabeling,
    lexicographic edge order, structural features, node-label classes.

    Both the view-fed path (:meth:`ViewSubgraph.to_graphbatch`) and the
    re-extract-from-scratch differential twin build through here, so batch
    equality reduces to edge-set equality regardless of extraction order.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = (np.ones(src.shape[0], np.int64) if weight is None
         else np.asarray(weight, np.int64))
    ids = np.unique(np.concatenate([src, dst]))
    loc = np.zeros(num_nodes, np.int64)
    loc[ids] = np.arange(ids.shape[0])
    ls, ld = loc[src], loc[dst]
    order = np.lexsort((ld, ls))
    ls, ld, w = ls[order], ld[order], w[order]
    in_deg = np.zeros(num_nodes, np.int64)
    out_deg = np.zeros(num_nodes, np.int64)
    np.add.at(in_deg, dst, 1)
    np.add.at(out_deg, src, 1)
    feat = structural_features(ids, in_deg, out_deg, node_label)
    return pad_graph(feat, ls.astype(np.int32), ld.astype(np.int32),
                     labels=node_label[ids].astype(np.int32),
                     edge_weight=w.astype(np.float32),
                     node_pad=node_pad, edge_pad=edge_pad, device=device)


class ViewSubgraph:
    """An incrementally-maintained training subgraph over a view's edges.

    Obtained via :meth:`~repro_torch.core.views.ViewHandle.subgraph`.  Holds one
    epoch-keyed slice per edge label; :meth:`refresh` re-extracts only the
    labels a write actually touched and rebuilds the merged CSR only when a
    slice changed.  ``slice_rebuilds``/``csr_rebuilds`` count the work done
    (the incremental-refresh tests and the gnn bench assert on them).
    """

    def __init__(self, session: "GraphSession", view_name: str,
                 extra_labels: Sequence[str] = (), weighted: bool = False):
        self._sess = session
        self.view_name = view_name
        self.extra_labels = tuple(extra_labels)
        self.weighted = weighted
        self.version = 0
        self.csr_rebuilds = 0
        self.slice_rebuilds: Dict[str, int] = {}
        self._slices: Dict[str, Tuple[tuple, EdgeSlice]] = {}
        self._coo: Optional[EdgeSlice] = None
        self._csr: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._csr_cap = -1
        self._sampler: Optional[NeighborSampler] = None
        self._sampler_version = -1
        self._nodes: Optional[np.ndarray] = None
        self._node_label: Optional[np.ndarray] = None
        self.refresh()

    # ------------------------------------------------------------- anatomy

    @property
    def view(self) -> "MaterializedView":
        v = self._sess.views.get(self.view_name)
        if v is None:
            raise ValueError(
                f"view {self.view_name!r} was dropped; this subgraph is dead")
        return v

    @property
    def stale(self) -> bool:
        """Queued, undrained maintenance deltas exist for the view."""
        return self.view.is_stale

    @property
    def num_nodes(self) -> int:
        return int(self._sess.g.node_cap)

    @property
    def edge_count(self) -> int:
        return 0 if self._coo is None else int(self._coo.src.shape[0])

    def _epoch_key(self, label_id: int) -> tuple:
        ep = self._sess.engine.epochs
        return (ep.of(label_id), ep.reset_generation)

    # ------------------------------------------------------------- refresh

    def _extract_view_slice(self, view: "MaterializedView") -> EdgeSlice:
        """The view's own edges, read off the maintained host pair index —
        no match re-execution, no device round trip per pair."""
        g = self._sess.g
        m = len(view.pair_slot)
        pairs = np.fromiter((c for k in view.pair_slot for c in k),
                            np.int64, 2 * m).reshape(m, 2)
        slots = np.fromiter(view.pair_slot.values(), np.int64, m)
        keep = host(g.edge_alive)[slots] if m else np.zeros(0, bool)
        src, dst, slots = pairs[keep, 0], pairs[keep, 1], slots[keep]
        w = (host(g.edge_weight)[slots].astype(np.int64)
             if self.weighted and slots.size
             else np.ones(src.shape[0], np.int64))
        return EdgeSlice(src, dst, w)

    def _extract_base_slice(self, label: str) -> EdgeSlice:
        """A base label's compact slice via the engine's per-label index
        (already epoch-cached device-side; one host view per epoch move)."""
        lid = self._sess.schema.edge_labels.maybe_id(label)
        if lid < 0:
            return EdgeSlice(np.zeros(0, np.int64), np.zeros(0, np.int64),
                             np.zeros(0, np.int64))
        esrc, edst, ew, emask = self._sess.engine.label_edges(lid)
        keep = host(emask)
        src = host(esrc)[keep].astype(np.int64)
        dst = host(edst)[keep].astype(np.int64)
        w = (host(ew)[keep].astype(np.int64) if self.weighted
             else np.ones(src.shape[0], np.int64))
        return EdgeSlice(src, dst, w)

    def refresh(self, drain: Optional[bool] = None) -> bool:
        """Bring the CSR up to date with the view's maintained edges.

        ``drain=None`` follows the view's freshness policy (deferred views
        drain like any conflicting read; bounded-stale views within bound
        answer stale); ``drain=True`` forces a drain; ``drain=False`` skips
        it (train on the stale snapshot).  Returns True when the merged CSR
        changed (``version`` bumped).
        """
        view = self.view
        if view.is_stale and (drain or (drain is None and
                              self._sess._read_triggers_drain(view))):
            self._sess.refresh(view.name)
        changed = False
        for label in (view.name,) + self.extra_labels:
            lid = (view.label_id if label == view.name
                   else self._sess.schema.edge_labels.maybe_id(label))
            key = self._epoch_key(lid)
            ent = self._slices.get(label)
            if ent is not None and ent[0] == key:
                continue
            sl = (self._extract_view_slice(view) if label == view.name
                  else self._extract_base_slice(label))
            old = ent[1] if ent is not None else None
            self._slices[label] = (key, sl)
            self.slice_rebuilds[label] = self.slice_rebuilds.get(label, 0) + 1
            if (old is None or old.src.shape != sl.src.shape
                    or not (np.array_equal(old.src, sl.src)
                            and np.array_equal(old.dst, sl.dst)
                            and np.array_equal(old.weight, sl.weight))):
                changed = True
        cap = self.num_nodes
        if changed or self._csr is None or cap != self._csr_cap:
            slices = [self._slices[lbl][1]
                      for lbl in (view.name,) + self.extra_labels]
            self._coo = EdgeSlice(
                np.concatenate([s.src for s in slices]),
                np.concatenate([s.dst for s in slices]),
                np.concatenate([s.weight for s in slices]))
            # CSR over incoming edges — NeighborSampler's orientation
            # (sampling neighbors that message INTO the seeds)
            indptr, nbrs, _ = build_csr(self._coo.dst, self._coo.src, cap)
            self._csr = (indptr, nbrs)
            self._csr_cap = cap
            self._nodes = None
            self.csr_rebuilds += 1
            self.version += 1
            self._node_label = host(self._sess.g.node_label).copy()
            return True
        return False

    # ------------------------------------------------------------ consumers

    def edges(self) -> EdgeSlice:
        """The merged COO edge slice (arena node ids)."""
        self.refresh()
        return self._coo

    def csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """(indptr, neighbors) over incoming edges, arena node id space."""
        self.refresh()
        return self._csr

    def nodes(self) -> np.ndarray:
        """Sorted unique endpoint ids of the subgraph's edges."""
        self.refresh()
        if self._nodes is None:
            self._nodes = np.unique(
                np.concatenate([self._coo.src, self._coo.dst]))
        return self._nodes

    def seed_nodes(self) -> np.ndarray:
        """Natural sampling seeds: nodes with incoming subgraph edges."""
        self.refresh()
        return np.unique(self._coo.dst)

    def sampler(self) -> NeighborSampler:
        """A :class:`NeighborSampler` over the maintained CSR (shared, not
        re-sorted — rebuilt only when :meth:`refresh` changed the CSR)."""
        self.refresh()
        if self._sampler is None or self._sampler_version != self.version:
            self._sampler = NeighborSampler.from_csr(
                self._csr[0], self._csr[1], self._csr_cap)
            self._sampler_version = self.version
        return self._sampler

    def node_label_host(self) -> np.ndarray:
        """Host copy of the arena node-label column (refresh-synced)."""
        self.refresh()
        return self._node_label

    def to_graphbatch(self, node_pad: int = 128,
                      edge_pad: int = 128) -> GraphBatch:
        """The whole maintained subgraph as one padded :class:`GraphBatch`
        on the session's device."""
        self.refresh()
        return build_graphbatch(
            self._coo.src, self._coo.dst, node_label=self._node_label,
            num_nodes=self._csr_cap,
            weight=self._coo.weight if self.weighted else None,
            node_pad=node_pad, edge_pad=edge_pad, device=self._sess.device)

    def batch_from_sample(self, sg: SampledSubgraph, node_pad: int = 128,
                          edge_pad: int = 128) -> GraphBatch:
        """A sampled minibatch as a padded :class:`GraphBatch` on the
        session's device (features from the *full* subgraph's structure,
        labels from the node arena)."""
        coo = self._coo
        in_deg = np.zeros(self._csr_cap, np.int64)
        out_deg = np.zeros(self._csr_cap, np.int64)
        np.add.at(in_deg, coo.dst, 1)
        np.add.at(out_deg, coo.src, 1)
        feat = structural_features(sg.node_ids, in_deg, out_deg,
                                   self._node_label)
        return pad_graph(feat, sg.edge_src, sg.edge_dst,
                         labels=self._node_label[sg.node_ids].astype(np.int32),
                         node_pad=node_pad, edge_pad=edge_pad,
                         device=self._sess.device)


def view_to_graphbatch(session: "GraphSession", view, **kw) -> GraphBatch:
    """One-shot adapter: ``view`` is a name or a ViewHandle; returns the
    maintained subgraph as a :class:`GraphBatch` (no re-extraction)."""
    name = view if isinstance(view, str) else view.name
    return session.view(name).subgraph().to_graphbatch(**kw)

"""Templated view maintenance — the paper's central contribution (§IV-B).

The port of ``repro.core.maintenance``; its own logic is host-side numpy,
and every read of graph columns goes through :func:`repro_torch.utils.host`.

At view-creation time we pre-generate *maintenance templates* exactly per
Algorithms 1 and 2: for every position a deleted node / created / deleted edge
can occupy in the view's match path — explicit positions and positions *inside*
a variable-length edge (enumerated by split distance ``i``) — we emit one
template.  A template is a (prefix, suffix) pair of path patterns around the
update site Δ; instantiating a template substitutes Δ's identity (the paper's
``$L/$K/$V`` / ``$RID`` parameters become runtime arguments of pre-staged
delta programs).

Delta semantics (documented in DESIGN.md §2; exact, fixing the paper's
acknowledged duplicate-instance issue):

* **create edge** (counting views): the template splits are precisely the
  telescoping identity ``A_new^k − A_old^k = Σ_i A_new^i·E·A_old^{k−1−i}`` —
  prefix sides evaluate on the *new* graph, suffix sides on the *old* graph,
  so every new path instance is counted exactly once.
* **delete edge** (counting views): same telescoping with prefix on *old*,
  suffix on *new*; weights decrement, zero-weight view edges die.
* **delete node / any delete on set-semantics (unbounded) views**: the
  templates delimit the *affected sources* (backward reach from Δ through the
  template prefixes); the view rows of affected sources are re-derived on the
  updated graph.  Cost is O(affected region) — the paper's O(N).
* **create node**: no-op (paper §IV-B).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.executor import ExecConfig, Metrics, PathExecutor
from repro_torch.core.graph import PropertyGraph, gathered_pred_mask
from repro_torch.core.pattern import (
    Direction, NodePat, PathPattern, PropPred, RelPat, ViewDef,
    normalize_preds,
)
from repro_torch.core.schema import GraphSchema, NO_LABEL
from repro_torch.utils import INF_HOPS, host


# ---------------------------------------------------------------------------
# Template IR
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Split:
    """Hop-range split of a variable-length edge around the update site."""

    prefix_hops: Tuple[int, int]   # (lo, hi) between segment start and Δ
    suffix_hops: Tuple[int, int]   # (lo, hi) between Δ and segment end


@dataclass(frozen=True)
class MaintTemplate:
    """One maintenance statement template.

    ``kind``: 'node' (Algorithm 1) or 'edge' (Algorithm 2).
    ``position``: index of the explicit node/rel in the match path, or the
    index of the variable-length rel the split refers to.
    ``split``: None for explicit positions.
    ``prefix``: path from the view's start node *to* Δ (run reversed from Δ).
    ``suffix``: path from Δ to the view's end node.
    ``node_label``/``rel_label``: compile-time label constraints that the
    runtime Δ must satisfy for the statement to produce matches.
    """

    kind: str
    view_name: str
    position: int
    split: Optional[Split]
    prefix: PathPattern
    suffix: PathPattern
    node_label: Optional[str] = None
    node_key_required: bool = False
    rel_label: Optional[str] = None

    def pretty(self) -> str:
        """Render as the paper's Cypher-ish template text (Listings 2-3)."""
        hole = "(:$L{$K:$V})" if self.kind == "node" else \
               "(:$SL{$SK:$SV})-[@R]->(:$DL{$DK:$DV})"
        pre = self.prefix.pretty()
        suf = self.suffix.pretty()
        # prefix ends at Δ and suffix starts at Δ; drop the duplicated hole node
        return f"MATCH {pre[: pre.rfind('(')]}{hole}{suf[suf.find(')') + 1:]}"


def _subpath(path: PathPattern, node_lo: int, node_hi: int) -> PathPattern:
    """Nodes node_lo..node_hi inclusive with the rels between them."""
    return PathPattern(nodes=path.nodes[node_lo:node_hi + 1],
                       rels=path.rels[node_lo:node_hi])


_HOLE = NodePat(var="__delta__")  # unconstrained placeholder node for Δ


def _with_range(rel: RelPat, lo: int, hi: int) -> RelPat:
    return replace(rel, min_hops=lo, max_hops=hi, var=None)


def _append_rel(path: PathPattern, rel: RelPat, node: NodePat) -> PathPattern:
    return PathPattern(nodes=path.nodes + (node,), rels=path.rels + (rel,))


def _prepend_rel(node: NodePat, rel: RelPat, path: PathPattern) -> PathPattern:
    return PathPattern(nodes=(node,) + path.nodes, rels=(rel,) + path.rels)


# ---------------------------------------------------------------------------
# Algorithm 1: templates for deleting a node
# ---------------------------------------------------------------------------

def node_delete_templates(vdef: ViewDef) -> List[MaintTemplate]:
    path = vdef.match
    out: List[MaintTemplate] = []
    # lines 4-6: explicit node positions
    for j, node in enumerate(path.nodes):
        out.append(MaintTemplate(
            kind="node", view_name=vdef.name, position=j, split=None,
            prefix=_subpath(path, 0, j),
            suffix=_subpath(path, j, len(path.nodes) - 1),
            node_label=node.label,
            node_key_required=node.key is not None,
        ))
    # lines 7-26: positions inside variable-length edges
    for t, rel in enumerate(path.rels):
        if not rel.is_varlen:
            continue
        n, m = rel.min_hops, rel.max_hops
        pre_base = _subpath(path, 0, t)          # ends at rel's left node
        suf_base = _subpath(path, t + 1, len(path.nodes) - 1)
        splits: List[Split] = []
        if m == INF_HOPS:
            top = max(n - 1, 1)
            for i in range(1, top + 1):
                if i < top:
                    splits.append(Split((i, i), (n - i, INF_HOPS)))
                else:
                    splits.append(Split((i, INF_HOPS), (1, INF_HOPS)))
        else:
            for i in range(1, m):
                splits.append(Split((i, i), (max(n - i, 1), m - i)))
        for s in splits:
            out.append(MaintTemplate(
                kind="node", view_name=vdef.name, position=t, split=s,
                prefix=_append_rel(pre_base, _with_range(rel, *s.prefix_hops), _HOLE),
                suffix=_prepend_rel(_HOLE, _with_range(rel, *s.suffix_hops), suf_base),
                node_label=None,  # interior vlen nodes are unconstrained
            ))
    return out


# ---------------------------------------------------------------------------
# Algorithm 2: templates for creating or deleting an edge
# ---------------------------------------------------------------------------

def edge_templates(vdef: ViewDef) -> List[MaintTemplate]:
    path = vdef.match
    out: List[MaintTemplate] = []
    # lines 4-6: explicit fixed-length edges
    for t, rel in enumerate(path.rels):
        if rel.is_varlen:
            continue
        out.append(MaintTemplate(
            kind="edge", view_name=vdef.name, position=t, split=None,
            prefix=_subpath(path, 0, t),
            suffix=_subpath(path, t + 1, len(path.nodes) - 1),
            rel_label=rel.label,
        ))
    # lines 7-26: inside variable-length edges
    for t, rel in enumerate(path.rels):
        if not rel.is_varlen:
            continue
        n, m = rel.min_hops, rel.max_hops
        pre_base = _subpath(path, 0, t)
        suf_base = _subpath(path, t + 1, len(path.nodes) - 1)
        splits: List[Split] = []
        if m == INF_HOPS:
            top = max(n - 1, 0)
            for i in range(0, top + 1):
                if i < top:
                    splits.append(Split((i, i), (n - 1 - i, INF_HOPS)))
                else:
                    splits.append(Split((i, INF_HOPS), (0, INF_HOPS)))
        else:
            for i in range(0, m):
                splits.append(Split((i, i), (max(n - 1 - i, 0), m - 1 - i)))
        for s in splits:
            out.append(MaintTemplate(
                kind="edge", view_name=vdef.name, position=t, split=s,
                prefix=_append_rel(pre_base, _with_range(rel, *s.prefix_hops), _HOLE),
                suffix=_prepend_rel(_HOLE, _with_range(rel, *s.suffix_hops), suf_base),
                rel_label=rel.label,
            ))
    return out


@dataclass
class ViewTemplates:
    """The paper's M_VMT entry for one view (Figure 6)."""

    node_delete: List[MaintTemplate]
    edge: List[MaintTemplate]          # shared by create/delete (isCreate flag)

    @staticmethod
    def generate(vdef: ViewDef) -> "ViewTemplates":
        return ViewTemplates(node_delete=node_delete_templates(vdef),
                             edge=edge_templates(vdef))


# ---------------------------------------------------------------------------
# Runtime delta evaluation
# ---------------------------------------------------------------------------

def _delta_exec(g: PropertyGraph, schema: GraphSchema, cfg: ExecConfig
                ) -> PathExecutor:
    small = ExecConfig(backend="segment", src_block=8,
                       max_closure_iters=cfg.max_closure_iters,
                       collect_metrics=False)
    return PathExecutor(g, schema, small)


def _run_from(ex: PathExecutor, path: PathPattern, start_ids: Sequence[int],
              counting: bool, metrics: Metrics) -> np.ndarray:
    """Run ``path`` from explicit start ids; returns [len(ids), N] counts."""
    res = ex.run_path(path, counting=counting,
                      sources=np.asarray(start_ids, np.int32))
    metrics += res.metrics
    return res.reach


def template_prefix_row(ex: PathExecutor, tpl: MaintTemplate, delta_id: int,
                        counting: bool, metrics: Metrics) -> np.ndarray:
    """counts/bool over sources s: paths s -> Δ matching the template prefix.

    The prefix runs *reversed* from Δ (single-source) — this is how template
    instantiation stays O(delta).
    """
    rev = tpl.prefix.reversed()
    return _run_from(ex, rev, [delta_id], counting, metrics)[0]


def template_suffix_row(ex: PathExecutor, tpl: MaintTemplate, delta_id: int,
                        counting: bool, metrics: Metrics) -> np.ndarray:
    """counts/bool over dests d: paths Δ -> d matching the template suffix."""
    return _run_from(ex, tpl.suffix, [delta_id], counting, metrics)[0]


def _endpoint_ok(g: PropertyGraph, schema: GraphSchema, node: NodePat,
                 node_id: int) -> bool:
    lid = schema.node_label_id(node.label)
    if lid != NO_LABEL and int(host(g.node_label[node_id])) != lid:
        return False
    if node.key is not None and int(host(g.node_key[node_id])) != node.key:
        return False
    for p in node.preds:
        col = g.node_props.get(p.prop)
        if not p.holds(int(host(col[node_id])) if col is not None else 0):
            return False
    return True


def _node_pat_mask(schema: GraphSchema, node: NodePat, ids: np.ndarray,
                   labels: np.ndarray, keys: np.ndarray,
                   g: PropertyGraph) -> np.ndarray:
    """Vectorized ``_endpoint_ok`` over host copies of the node arrays."""
    lid = schema.node_label_id(node.label)
    m = np.ones(ids.shape[0], bool)
    if lid != NO_LABEL:
        m &= labels[ids] == lid
    if node.key is not None:
        m &= keys[ids] == node.key
    if node.preds:
        m &= gathered_pred_mask(g.node_props, node.preds, ids)
    return m


def _edge_pred_keep(g: PropertyGraph, preds: "tuple[PropPred, ...]",
                    edge_ids: np.ndarray) -> np.ndarray:
    """Host bool mask: which Δ edges satisfy a template rel's predicates.

    A delta edge that fails the matched rel's predicate cannot extend any
    path instance of the view, so it must contribute zero to the telescoped
    delta — label matching alone is no longer sufficient with predicates."""
    return gathered_pred_mask(g.edge_props, preds, edge_ids)


@dataclass
class DeltaPairs:
    """Sparse (src, dst, count) delta produced by template instantiation."""

    src: np.ndarray
    dst: np.ndarray
    count: np.ndarray

    @staticmethod
    def empty() -> "DeltaPairs":
        z = np.zeros(0, np.int32)
        return DeltaPairs(z, z, z)

    @staticmethod
    def from_outer(pre_row: np.ndarray, suf_row: np.ndarray,
                   counting: bool) -> "DeltaPairs":
        s_ids = np.flatnonzero(pre_row).astype(np.int32)
        d_ids = np.flatnonzero(suf_row).astype(np.int32)
        if s_ids.size == 0 or d_ids.size == 0:
            return DeltaPairs.empty()
        ss, dd = np.meshgrid(s_ids, d_ids, indexing="ij")
        if counting:
            cc = np.outer(pre_row[s_ids], suf_row[d_ids]).astype(np.int64)
        else:
            cc = np.ones(ss.shape, np.int64)
        return DeltaPairs(ss.ravel(), dd.ravel(), cc.ravel())

    def merged(self) -> "DeltaPairs":
        if self.src.size == 0:
            return self
        key = self.src.astype(np.int64) << 32 | self.dst.astype(np.int64)
        uk, inv = np.unique(key, return_inverse=True)
        cnt = np.zeros(uk.shape[0], np.int64)
        np.add.at(cnt, inv, self.count)
        return DeltaPairs((uk >> 32).astype(np.int32),
                          (uk & 0xFFFFFFFF).astype(np.int32), cnt)

    def concat(self, other: "DeltaPairs") -> "DeltaPairs":
        return DeltaPairs(np.concatenate([self.src, other.src]),
                          np.concatenate([self.dst, other.dst]),
                          np.concatenate([self.count, other.count]))


def _tpl_matches_label(tpl: MaintTemplate, edge_label: str,
                       delta_is_view: bool) -> bool:
    """Does a delta edge of ``edge_label`` instantiate this template?

    Explicit rel labels must match exactly.  A wildcard template rel spans
    *base* labels only (the schema's base/view partition): view-labeled
    deltas never instantiate it, so view churn cannot feed back into other
    views' (or the view's own) maintenance through unlabeled rels.
    """
    if tpl.rel_label is not None:
        return tpl.rel_label == edge_label
    return not delta_is_view


def edge_delta_pairs(
    templates: ViewTemplates,
    vdef: ViewDef,
    g_prefix: PropertyGraph,
    g_suffix: PropertyGraph,
    schema: GraphSchema,
    cfg: ExecConfig,
    edge_src: int,
    edge_dst: int,
    edge_label: str,
    counting: bool,
    metrics: Metrics,
    ex_pre: PathExecutor | None = None,
    ex_suf: PathExecutor | None = None,
    edge_id: Optional[int] = None,
) -> DeltaPairs:
    """Exact path-count delta for one created/deleted edge.

    ``g_prefix``/``g_suffix`` select the telescoping sides:
      create: (new, old);  delete: (old, new).
    For set semantics both sides are the new graph (create) — delete is
    handled by affected-recompute instead (see views.py).  ``edge_id`` is
    required when the view carries relationship predicates (property values
    are read from ``g_prefix``, where the Δ edge is alive).
    """
    ex_pre = ex_pre or _delta_exec(g_prefix, schema, cfg)
    ex_suf = ex_suf or _delta_exec(g_suffix, schema, cfg)
    delta_is_view = schema.is_view_edge_label(edge_label)
    acc = DeltaPairs.empty()
    for tpl in templates.edge:
        if not _tpl_matches_label(tpl, edge_label, delta_is_view):
            continue
        rel = vdef.match.rels[tpl.position]
        rpreds = normalize_preds(rel.preds)
        if rpreds:
            if edge_id is None:
                raise ValueError(
                    f"view {vdef.name!r} has relationship predicates; "
                    f"edge_delta_pairs needs edge_id to evaluate them")
            if not _edge_pred_keep(g_prefix, rpreds,
                                   np.asarray([edge_id], np.int32))[0]:
                continue
        # orient Δ's endpoints to the path direction of the matched rel;
        # undirected rels match the edge in either orientation
        if rel.direction is Direction.IN:
            orientations = [(edge_dst, edge_src)]
        elif rel.direction is Direction.OUT:
            orientations = [(edge_src, edge_dst)]
        else:
            orientations = [(edge_src, edge_dst), (edge_dst, edge_src)]
        for u, v in orientations:
            if tpl.split is None:
                # explicit edge: endpoints must satisfy adjacent node patterns
                if not _endpoint_ok(g_prefix, schema,
                                    vdef.match.nodes[tpl.position], u):
                    continue
                if not _endpoint_ok(g_suffix, schema,
                                    vdef.match.nodes[tpl.position + 1], v):
                    continue
            pre = _run_from(ex_pre, _subpath_rev(tpl.prefix), [u], counting,
                            metrics)[0]
            suf = _run_from(ex_suf, tpl.suffix, [v], counting, metrics)[0]
            acc = acc.concat(DeltaPairs.from_outer(pre, suf, counting))
    return acc.merged()


def _subpath_rev(path: PathPattern) -> PathPattern:
    return path.reversed()


# ---------------------------------------------------------------------------
# Batched (multi-Δ) template instantiation
# ---------------------------------------------------------------------------
#
# The telescoping identity is linear in the update:  for a batch delta
# Δ = Σ_j E_j of one label,  A_new^k − A_old^k = Σ_i A_new^i · Δ · A_old^{k−1−i}
# holds verbatim (each changed path instance is counted exactly once, at the
# last created / first deleted edge it uses).  So a batch of J edges needs one
# J-source ``run_path`` per (template, side) instead of J single-source runs —
# the executor blocks all J frontier rows into the same hops.

def batch_edge_delta_pairs(
    templates: ViewTemplates,
    vdef: ViewDef,
    schema: GraphSchema,
    edge_srcs: np.ndarray,
    edge_dsts: np.ndarray,
    edge_label: str,
    counting: bool,
    metrics: Metrics,
    ex_pre: PathExecutor,
    ex_suf: PathExecutor,
    edge_ids: Optional[np.ndarray] = None,
) -> DeltaPairs:
    """Exact path-count delta for a batch of created/deleted same-label edges.

    ``ex_pre``/``ex_suf`` select the telescoping sides exactly as in
    :func:`edge_delta_pairs` — create: (new, old); delete: (old, new); for a
    mixed batch the caller telescopes both steps around a common mid graph.
    Duplicate edges in the batch contribute with multiplicity, matching
    Δ = Σ_j E_j.

    ``edge_ids`` (arena slots, aligned with ``edge_srcs``/``edge_dsts``) are
    required when the view carries relationship predicates: a Δ edge failing
    the matched rel's predicate must contribute zero, and the property values
    are read per edge from the ``ex_pre`` side (where the Δ edge is alive in
    both telescoping regimes).
    """
    edge_srcs = np.asarray(edge_srcs, np.int32)
    edge_dsts = np.asarray(edge_dsts, np.int32)
    if edge_srcs.size == 0:
        return DeltaPairs.empty()
    delta_is_view = schema.is_view_edge_label(edge_label)
    parts: List[DeltaPairs] = []
    node_arrays = None  # host copies for endpoint checks, fetched on demand
    for tpl in templates.edge:
        if not _tpl_matches_label(tpl, edge_label, delta_is_view):
            continue
        rel = vdef.match.rels[tpl.position]
        rpreds = normalize_preds(rel.preds)
        if rpreds:
            if edge_ids is None:
                raise ValueError(
                    f"view {vdef.name!r} has relationship predicates; "
                    f"batch_edge_delta_pairs needs edge_ids to evaluate them")
            ekeep = _edge_pred_keep(ex_pre.g, rpreds,
                                    np.asarray(edge_ids, np.int32))
            if not ekeep.any():
                continue
            srcs_t, dsts_t = edge_srcs[ekeep], edge_dsts[ekeep]
        else:
            srcs_t, dsts_t = edge_srcs, edge_dsts
        if rel.direction is Direction.IN:
            orientations = [(dsts_t, srcs_t)]
        elif rel.direction is Direction.OUT:
            orientations = [(srcs_t, dsts_t)]
        else:
            orientations = [(srcs_t, dsts_t), (dsts_t, srcs_t)]
        for U, V in orientations:
            if tpl.split is None:
                if node_arrays is None:
                    node_arrays = (host(ex_pre.g.node_label),
                                   host(ex_pre.g.node_key),
                                   host(ex_suf.g.node_label),
                                   host(ex_suf.g.node_key))
                pre_nl, pre_nk, suf_nl, suf_nk = node_arrays
                keep = (_node_pat_mask(schema, vdef.match.nodes[tpl.position],
                                       U, pre_nl, pre_nk, ex_pre.g)
                        & _node_pat_mask(schema,
                                         vdef.match.nodes[tpl.position + 1],
                                         V, suf_nl, suf_nk, ex_suf.g))
                if not keep.any():
                    continue
                U_k, V_k = U[keep], V[keep]
            else:
                U_k, V_k = U, V
            pre = _run_from(ex_pre, tpl.prefix.reversed(), U_k, counting,
                            metrics)
            suf = _run_from(ex_suf, tpl.suffix, V_k, counting, metrics)
            for j in range(U_k.size):
                part = DeltaPairs.from_outer(pre[j], suf[j], counting)
                if part.src.size:
                    parts.append(part)
    if not parts:
        return DeltaPairs.empty()
    # single concatenate keeps the batched path linear in total pairs
    acc = DeltaPairs(np.concatenate([p.src for p in parts]),
                     np.concatenate([p.dst for p in parts]),
                     np.concatenate([p.count for p in parts]))
    return acc.merged()


def affected_sources_edges(templates: ViewTemplates, vdef: ViewDef,
                           schema: GraphSchema,
                           edge_srcs: np.ndarray, edge_dsts: np.ndarray,
                           edge_label: str, metrics: Metrics,
                           ex: PathExecutor,
                           edge_ids: Optional[np.ndarray] = None,
                           check_preds: bool = True) -> np.ndarray:
    """Batched :func:`affected_sources_edge`: one multi-source prefix run per
    template over every delta edge of the label.

    With ``check_preds`` (and ``edge_ids``) Δ edges failing a template rel's
    predicates are skipped — they cannot carry any view path.  Property
    *updates* pass ``check_preds=False``: the updated edge may satisfy the
    predicate on either side of the update, so the affected-source sweep must
    include it unconditionally (a superset is exact; recompute is
    idempotent)."""
    edge_srcs = np.asarray(edge_srcs, np.int32)
    edge_dsts = np.asarray(edge_dsts, np.int32)
    hit = np.zeros(ex.g.node_cap, bool)
    if edge_srcs.size == 0:
        return np.zeros(0, np.int32)
    delta_is_view = schema.is_view_edge_label(edge_label)
    for tpl in templates.edge:
        if not _tpl_matches_label(tpl, edge_label, delta_is_view):
            continue
        rel = vdef.match.rels[tpl.position]
        rpreds = normalize_preds(rel.preds) if check_preds else ()
        if rpreds and edge_ids is not None:
            ekeep = _edge_pred_keep(ex.g, rpreds,
                                    np.asarray(edge_ids, np.int32))
            if not ekeep.any():
                continue
            srcs_t, dsts_t = edge_srcs[ekeep], edge_dsts[ekeep]
        else:
            srcs_t, dsts_t = edge_srcs, edge_dsts
        if rel.direction is Direction.IN:
            starts = dsts_t
        elif rel.direction is Direction.OUT:
            starts = srcs_t
        else:
            starts = np.concatenate([srcs_t, dsts_t])
        starts = np.unique(starts)
        rows = _run_from(ex, tpl.prefix.reversed(), starts, counting=False,
                         metrics=metrics)
        hit |= rows.astype(bool).any(axis=0)
    return np.flatnonzero(hit).astype(np.int32)


def affected_sources_nodes(templates: ViewTemplates, vdef: ViewDef,
                           schema: GraphSchema, node_ids: np.ndarray,
                           metrics: Metrics, ex: PathExecutor) -> np.ndarray:
    """Batched :func:`affected_sources_node` over every deleted node at once."""
    node_ids = np.unique(np.asarray(node_ids, np.int32))
    hit = np.zeros(ex.g.node_cap, bool)
    if node_ids.size == 0:
        return np.zeros(0, np.int32)
    node_labels = host(ex.g.node_label)
    for tpl in templates.node_delete:
        if tpl.node_label is not None:
            lid = schema.node_label_id(tpl.node_label)
            ids = node_ids[node_labels[node_ids] == lid]
        else:
            ids = node_ids
        if ids.size == 0:
            continue
        rows = _run_from(ex, tpl.prefix.reversed(), ids, counting=False,
                         metrics=metrics)
        hit |= rows.astype(bool).any(axis=0)
    return np.flatnonzero(hit).astype(np.int32)


def affected_sources_node(templates: ViewTemplates, vdef: ViewDef,
                          g: PropertyGraph, schema: GraphSchema,
                          cfg: ExecConfig, node_id: int,
                          metrics: Metrics,
                          ex: PathExecutor | None = None) -> np.ndarray:
    """Sources whose view rows may change when ``node_id`` is deleted."""
    ex = ex or _delta_exec(g, schema, cfg)
    hit = np.zeros(g.node_cap, bool)
    for tpl in templates.node_delete:
        if tpl.node_label is not None:
            lid = schema.node_label_id(tpl.node_label)
            if int(host(g.node_label[node_id])) != lid:
                continue
        row = template_prefix_row(ex, tpl, node_id, counting=False,
                                  metrics=metrics)
        hit |= row.astype(bool)
    return np.flatnonzero(hit).astype(np.int32)


def affected_sources_edge(templates: ViewTemplates, vdef: ViewDef,
                          g: PropertyGraph, schema: GraphSchema,
                          cfg: ExecConfig, edge_src: int, edge_dst: int,
                          edge_label: str, metrics: Metrics,
                          ex: PathExecutor | None = None) -> np.ndarray:
    """Sources whose view rows may change when edge (src,dst,label) changes."""
    ex = ex or _delta_exec(g, schema, cfg)
    hit = np.zeros(g.node_cap, bool)
    delta_is_view = schema.is_view_edge_label(edge_label)
    for tpl in templates.edge:
        if not _tpl_matches_label(tpl, edge_label, delta_is_view):
            continue
        rel = vdef.match.rels[tpl.position]
        if rel.direction is Direction.IN:
            starts = [edge_dst]
        elif rel.direction is Direction.OUT:
            starts = [edge_src]
        else:
            starts = [edge_src, edge_dst]
        for u in starts:
            row = template_prefix_row(ex, tpl, u, counting=False,
                                      metrics=metrics)
            hit |= row.astype(bool)
    return np.flatnonzero(hit).astype(np.int32)


# ---------------------------------------------------------------------------
# Freshness subsystem: per-view delta queues + on-demand drain (DESIGN.md §11)
# ---------------------------------------------------------------------------

@dataclass
class PendingDelta:
    """Queued maintenance work for one non-exact view.

    Writes under a ``deferred``/``bounded_stale`` policy skip template
    evaluation entirely: the base graph mutates immediately (only the view's
    materialized edges go stale) and each touched element's *structural
    endpoints* are appended here, coalesced per (view, label) through
    :meth:`DeltaPairs.concat`/:meth:`DeltaPairs.merged` — delete/recreate
    churn on the same (src, dst) collapses to one queue row, which is what
    makes a drain after N writes cheaper than N exact passes.

    The queue must contain every element whose mutation can invalidate or
    create a view path: deleted edges, created edges, the incident edges of
    deleted nodes (captured *before* the deletion), property-touched edges
    (by label), and property-touched nodes (for properties the view reads).
    Given that, a single affected-source sweep per queue group on the
    *current* graph is exact: for any stored row whose supporting path broke,
    the first invalidated element has an intact, constraint-satisfying prefix
    in the current graph — every earlier element would otherwise itself be a
    queued first break — so the reverse-prefix run from the queued element
    reaches the row's source.  New paths are found symmetrically.  The sweep
    runs with ``check_preds=False`` (a queued element may satisfy predicates
    on either side of its mutation); supersets are exact because the
    follow-up recompute is idempotent.
    """

    edges: Dict[str, DeltaPairs] = field(default_factory=dict)
    nodes: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    writes: int = 0            # queue rows appended (staleness, write count)
    first_epoch: int = -1      # session write epoch of the first enqueue

    @property
    def is_empty(self) -> bool:
        return self.writes == 0

    def add_edges(self, label: str, srcs: np.ndarray,
                  dsts: np.ndarray, epoch: int) -> None:
        srcs = np.asarray(srcs, np.int32)
        if srcs.size == 0:
            return
        add = DeltaPairs(srcs, np.asarray(dsts, np.int32),
                         np.ones(srcs.size, np.int64))
        cur = self.edges.get(label)
        self.edges[label] = (add if cur is None
                             else cur.concat(add)).merged()
        self._note(int(srcs.size), epoch)

    def add_nodes(self, node_ids: np.ndarray, epoch: int) -> None:
        node_ids = np.asarray(node_ids, np.int32)
        if node_ids.size == 0:
            return
        self.nodes = np.union1d(self.nodes, node_ids).astype(np.int32)
        self._note(int(node_ids.size), epoch)

    def _note(self, n: int, epoch: int) -> None:
        self.writes += n
        if self.first_epoch < 0:
            self.first_epoch = epoch

    def staleness(self, current_epoch: int) -> int:
        """Staleness degree: max of queued-write count and epoch age."""
        if self.is_empty:
            return 0
        return max(self.writes, current_epoch - self.first_epoch)

    def clear(self) -> None:
        self.edges = {}
        self.nodes = np.zeros(0, np.int32)
        self.writes = 0
        self.first_epoch = -1


def pending_affected_sources(pending: PendingDelta, templates: ViewTemplates,
                             vdef: ViewDef, schema: GraphSchema,
                             metrics: Metrics, ex: PathExecutor) -> np.ndarray:
    """Drain sweep: affected sources of every queued delta, evaluated on the
    *current* graph (``ex``).  One :func:`affected_sources_edges` pass per
    queued (label) group plus one :func:`affected_sources_nodes` pass over
    property-touched nodes; predicates on the queued elements themselves are
    skipped (see :class:`PendingDelta`)."""
    affected = np.zeros(0, np.int32)
    for label, dp in pending.edges.items():
        aff = affected_sources_edges(
            templates, vdef, schema, dp.src, dp.dst, label,
            metrics=metrics, ex=ex, edge_ids=None, check_preds=False)
        affected = np.union1d(affected, aff).astype(np.int32)
    if pending.nodes.size:
        aff = affected_sources_nodes(
            templates, vdef, schema, pending.nodes, metrics=metrics, ex=ex)
        affected = np.union1d(affected, aff).astype(np.int32)
    return affected


"""View catalog and graph session: creation, storage, incremental maintenance.

View edges are materialized *into the graph arena* as real edges labeled with
the view name — exactly the paper's realization ("store the query result as a
new edge labeled ROOT_POST").  Bag semantics (one result row per path
instance) is preserved compactly via the per-edge ``weight`` = path count;
unbounded (``*n..``) views use set semantics with weight 1 (counting infinite
walk families is undefined; see DESIGN.md §2).

Because view edges share the arena with base edges, view labels live in a
separate schema partition (``GraphSchema.register_view_label``): wildcard
relationships, maintenance triggering (:meth:`GraphSession._uses_label`) and
``check_consistency`` all treat "any label" as "any *base* label", so
materialized views never leak phantom rows into unlabeled-rel queries.

The session owns one persistent :class:`~repro_torch.core.executor.ExecEngine`
(DESIGN.md §4): per-label compact edge slices, degree vectors and dense
adjacency tiles survive across queries and writes, and a mutation invalidates
only the labels it touched.  Writes go through :meth:`GraphSession.apply_writes`
— single-op ``create_edge``/``delete_edge``/``delete_node`` are one-element
batches — and maintenance evaluates one grouped telescoped delta per
(view, label) instead of one per edge.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core import graph as G
from repro_torch.core.executor import (
    ExecConfig, ExecEngine, Metrics, PathExecutor, ReachResult,
)
from repro_torch.core.maintenance import (
    DeltaPairs, PendingDelta, ViewTemplates, affected_sources_edges,
    affected_sources_nodes, batch_edge_delta_pairs,
    pending_affected_sources,
)
from repro_torch.core.parser import parse_query, parse_view
from repro_torch.core.pattern import FreshnessPolicy, Query, ViewDef
from repro_torch.core.plan import QueryPlanner
from repro_torch.core.schema import GraphSchema
from repro_torch.utils import host, resolve_device
from repro_torch.utils.device import DeviceLike
from repro_torch.utils.deprecation import warn_once


@dataclass
class ViewStats:
    """The paper's Eq. 1-2 bookkeeping for SortByOptEff."""

    n_sl: int            # |N_$SL|: nodes with the view's start label
    e_vl: int            # |E_$VL|: number of view edges
    init_db_hit: int     # DBHit_noV measured once, at creation
    opt_rate: float      # initialDBHit / (|N_SL| + 2|E_VL|)

    def db_hit_estimate(self) -> float:
        return (self.n_sl + 2 * self.e_vl) * self.opt_rate          # Eq. 2

    def opt_eff(self) -> float:
        return self.db_hit_estimate() - (self.n_sl + 2 * self.e_vl)  # Eq. 1


@dataclass
class MaterializedView:
    vdef: ViewDef
    label_id: int                 # edge-label id of this view's edges
    counting: bool                # bag (finite hops) vs set (unbounded)
    templates: ViewTemplates
    stats: ViewStats
    pair_slot: Dict[Tuple[int, int], int] = field(default_factory=dict)
    creation_seconds: float = 0.0
    # freshness subsystem (DESIGN.md §11): queued deltas for non-exact
    # policies, and the session write epoch of the last drain
    pending: PendingDelta = field(default_factory=PendingDelta)
    drain_epoch: int = 0

    @property
    def name(self) -> str:
        return self.vdef.name

    @property
    def is_stale(self) -> bool:
        """Materialized edges lag the base graph (queued, undrained deltas)."""
        return not self.pending.is_empty

    def oriented(self, s: int, d: int) -> Tuple[int, int]:
        """Map a (match-start, match-end) pair to (view-src, view-dst)."""
        return (s, d) if self.vdef.forward else (d, s)


@dataclass
class BatchResult:
    """Slot ids assigned by :meth:`GraphSession.apply_writes`, in batch order."""

    edge_slots: np.ndarray   # arena slots of batch.edge_creates
    node_slots: np.ndarray   # arena slots of batch.node_creates


@dataclass
class ViewStatus:
    """Read-only status snapshot returned by :meth:`ViewHandle.stats`.

    Carries the Eq. 1-2 bookkeeping of :class:`ViewStats` plus the
    freshness-subsystem state.  Callable returning itself, so both the
    blessed ``handle.stats()`` and the historical attribute-style
    ``handle.stats.e_vl`` read the same snapshot.
    """

    name: str
    policy: "FreshnessPolicy"
    stale: bool
    pending_writes: int      # queued, undrained delta entries
    drain_epoch: int
    creation_seconds: float
    n_sl: int
    e_vl: int
    init_db_hit: int
    opt_rate: float

    def db_hit_estimate(self) -> float:
        return (self.n_sl + 2 * self.e_vl) * self.opt_rate          # Eq. 2

    def opt_eff(self) -> float:
        return self.db_hit_estimate() - (self.n_sl + 2 * self.e_vl)  # Eq. 1

    def __call__(self) -> "ViewStatus":
        return self


class ViewHandle:
    """The public face of a materialized view (DESIGN.md §14).

    Returned by :meth:`GraphSession.create_view` / :meth:`GraphSession.view`.
    Holds no state beyond (session, name): every access resolves through the
    live catalog, so a handle observes drains/drops immediately and two
    handles to one view never diverge.  Unknown attributes delegate to the
    underlying :class:`MaterializedView`, which keeps pre-§14 call shapes
    (``v.pair_slot``, ``v.label_id``, ``v.vdef`` ...) working.
    """

    __slots__ = ("_sess", "name")

    def __init__(self, sess: "GraphSession", name: str):
        object.__setattr__(self, "_sess", sess)
        object.__setattr__(self, "name", name)

    @property
    def _view(self) -> MaterializedView:
        v = self._sess.views.get(self.name)
        if v is None:
            raise ValueError(f"view {self.name!r} has been dropped")
        return v

    def __getattr__(self, attr: str):
        return getattr(self._view, attr)

    def __repr__(self) -> str:
        v = self._sess.views.get(self.name)
        if v is None:
            return f"ViewHandle({self.name!r}, dropped)"
        return (f"ViewHandle({self.name!r}, {v.vdef.refresh.pretty()}, "
                f"e_vl={len(v.pair_slot)}"
                f"{', stale' if v.is_stale else ''})")

    # ------------------------------------------------------------- status

    @property
    def policy(self) -> "FreshnessPolicy":
        """The view's declared refresh policy."""
        return self._view.vdef.refresh

    @property
    def is_stale(self) -> bool:
        return self._view.is_stale

    @property
    def stats(self) -> ViewStatus:
        """Status snapshot (callable: ``handle.stats()`` == ``handle.stats``)."""
        v = self._view
        return ViewStatus(
            name=self.name, policy=v.vdef.refresh, stale=v.is_stale,
            pending_writes=v.pending.writes, drain_epoch=v.drain_epoch,
            creation_seconds=v.creation_seconds, n_sl=v.stats.n_sl,
            e_vl=v.stats.e_vl, init_db_hit=v.stats.init_db_hit,
            opt_rate=v.stats.opt_rate)

    # ------------------------------------------------------------ lifecycle

    def drain(self) -> bool:
        """Replay queued maintenance deltas now; True if any were queued."""
        return self._sess.refresh(self.name)

    def drop(self) -> None:
        """Drop the view and delete its arena edges (handle goes dead)."""
        self._sess.drop_view(self.name)

    # --------------------------------------------------- training substrate

    def subgraph(self, extra_labels=(), weighted: bool = False):
        raise NotImplementedError(
            "ViewHandle.subgraph is not ported yet (ROADMAP A9)")

    def sampler(self, **kw):
        raise NotImplementedError(
            "ViewHandle.sampler is not ported yet (ROADMAP A9)")

    def to_graphbatch(self, **kw):
        raise NotImplementedError(
            "ViewHandle.to_graphbatch is not ported yet (ROADMAP A9)")


class GraphSession:
    """Owns the graph + schema + view catalog; the workload entry point.

    Mirrors the paper's Figure 4: queries pass through the view-based
    optimizer; writes trigger template-driven maintenance.  All evaluation
    runs on one session-persistent engine with label-granular invalidation;
    the old/mid graph sides of telescoped deltas run on engine snapshots
    that share every still-valid cache entry.
    """

    def __init__(self, g: G.PropertyGraph, schema: GraphSchema,
                 cfg: Optional[ExecConfig] = None, auto_optimize: bool = True,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        if g.device != dev:
            g = g.to(dev)
        self.schema = schema
        self.cfg = cfg or ExecConfig()
        self.auto_optimize = auto_optimize
        self.views: Dict[str, MaterializedView] = {}
        self.last_maintenance_metrics = Metrics()
        self.last_rewrite_seconds = 0.0
        self.engine = ExecEngine(g, schema, self.cfg)
        # compiled-plan layer (core/plan.py): reads compile once per distinct
        # query shape; the view-set generation is a plan/rewrite-cache
        # invalidation key bumped by create_view/drop_view
        self.planner = QueryPlanner(self.engine, schema, self.cfg)
        self.view_set_generation = 0
        # freshness bookkeeping: one epoch per applied write batch (the
        # staleness age unit)
        self.write_epoch = 0
        self._delta_cfg = ExecConfig(
            backend="segment", src_block=8,
            max_closure_iters=self.cfg.max_closure_iters,
            collect_metrics=False)
        # persistent executors: reads use the workload config, delta sides the
        # small-block maintenance config; the old/mid wrappers are rebound to
        # engine snapshots per write (never rebuilt from scratch)
        self._exec = PathExecutor(engine=self.engine, cfg=self.cfg)
        self._delta = PathExecutor(engine=self.engine, cfg=self._delta_cfg)
        self._old_exec = PathExecutor(engine=self.engine, cfg=self._delta_cfg)
        self._mid_exec = PathExecutor(engine=self.engine, cfg=self._delta_cfg)
        self._aux_exec = PathExecutor(engine=self.engine, cfg=self._delta_cfg)

    # ------------------------------------------------------------- graph

    @property
    def g(self) -> G.PropertyGraph:
        return self.engine.g

    @property
    def device(self):
        return self.engine.device

    @g.setter
    def g(self, g: G.PropertyGraph) -> None:
        # external assignment: unknown delta -> conservative full invalidation
        self.engine.set_graph(g, None)

    def _set_graph(self, g: G.PropertyGraph,
                   touched_edge_labels: Optional[Iterable[int]]) -> None:
        self.engine.set_graph(g, touched_edge_labels)

    def _reserve_edge_slots(self, g: G.PropertyGraph, n: int
                            ) -> Tuple[G.PropertyGraph, np.ndarray]:
        """Reserve ``n`` free edge slots, growing the arena first if needed so
        growth cannot invalidate slots handed out earlier."""
        free = np.flatnonzero(~host(g.edge_alive))
        if free.shape[0] < n:
            g = G.grow_edge_arena(g, g.edge_cap + 2 * n + 128)
            free = np.flatnonzero(~host(g.edge_alive))
        return g, free[:n].astype(np.int32)

    def _reserve_node_slots(self, g: G.PropertyGraph, n: int
                            ) -> Tuple[G.PropertyGraph, np.ndarray, bool]:
        """Reserve ``n`` free node slots, growing the node arena if needed.

        Returns ``(graph, slots, grew)``.  Node growth changes ``node_cap``
        — the shape of frontiers, degree vectors and dense adjacency — so the
        caller must fully invalidate the engine when ``grew`` is True."""
        free = np.flatnonzero(~host(g.node_alive))
        grew = False
        if free.shape[0] < n:
            g = G.grow_node_arena(g, g.node_cap + 2 * n + 128)
            free = np.flatnonzero(~host(g.node_alive))
            grew = True
        return g, free[:n].astype(np.int32), grew

    # ----------------------------------------------------------- view create

    def _materialize_match(self, vdef: ViewDef, counting: bool,
                           fused: bool = True):
        """Evaluate the view's MATCH pattern over the current graph.

        ``fused=True`` (the default) routes materialization through the
        planner's :class:`~repro_torch.core.plan.CompiledPlan` — one fused
        program over blocked sources with one metric sync per block, the
        query read path, so repeated builds of the same shape reuse the
        cached plan.  ``fused=False`` keeps the per-hop host-synced
        :meth:`PathExecutor.run_path` loop (the paper's table 3 build path,
        retained as the benchmark twin and as ``check_consistency``'s
        independent oracle).  Both return a :class:`ReachResult` with
        identical pairs and metrics: the fused program reuses the row-local
        hop functions and folds per-row DBHit/Rows back to the ``S + Σvec``
        accounting ``run_path`` starts from.
        """
        if not fused:
            return self._exec.run_path(vdef.match, counting=counting)
        # views=[] -> use_views=False -> view_gen=None: the build plan is
        # catalog-independent (a view must never be defined through other
        # views' edges), and the planner's counting rule reduces to the
        # create_view rule (no force_bool, counting iff no unbounded rel)
        plan, _ = self.planner.plan(Query(path=vdef.match), [],
                                    self.view_set_generation)
        assert plan.counting == counting
        return plan.execute()

    def create_view(self, stmt: Union[str, ViewDef], *,
                    fused: bool = True) -> ViewHandle:
        """Materialize a view; returns its :class:`ViewHandle`."""
        vdef = parse_view(stmt) if isinstance(stmt, str) else stmt
        if vdef.name in self.views:
            raise ValueError(f"view {vdef.name!r} already exists")
        if (vdef.name in self.schema.edge_labels
                and not self.schema.is_view_edge_label(vdef.name)):
            raise ValueError(
                f"view name {vdef.name!r} collides with an existing base "
                f"edge label; view labels live in a separate partition")
        t0 = time.perf_counter()
        counting = not any(r.unbounded for r in vdef.match.rels)
        res = self._materialize_match(vdef, counting, fused=fused)
        s_ids, d_ids, cnt = res.pairs()

        label_id = self.schema.register_view_label(vdef.name)
        srcs, dsts = (s_ids, d_ids) if vdef.forward else (d_ids, s_ids)
        n_new = srcs.shape[0]
        g, slots = self._reserve_edge_slots(self.g, n_new)
        if n_new:
            g = G.create_edges(g, slots, srcs, dsts, label_id,
                               cnt if counting else np.ones_like(cnt))
        self._set_graph(g, {label_id})

        start_lid = self.schema.node_label_id(vdef.match.start.label)
        n_sl = int(self.g.node_mask(start_lid).sum())
        e_vl = int(n_new)
        init_db_hit = res.metrics.db_hits
        denom = max(n_sl + 2 * e_vl, 1)
        stats = ViewStats(n_sl=n_sl, e_vl=e_vl, init_db_hit=init_db_hit,
                          opt_rate=init_db_hit / denom)
        view = MaterializedView(
            vdef=vdef, label_id=label_id, counting=counting,
            templates=ViewTemplates.generate(vdef), stats=stats,
            pair_slot={(int(a), int(b)): int(sl)
                       for a, b, sl in zip(srcs, dsts, slots)},
            creation_seconds=time.perf_counter() - t0,
        )
        self.views[vdef.name] = view
        self.view_set_generation += 1
        return ViewHandle(self, vdef.name)

    def drop_view(self, name: str) -> None:
        """Drop a view and delete its arena edges.  The view's edge label
        stays registered in the schema's view partition (label ids are never
        recycled), so wildcard queries remain base-only either way."""
        if name not in self.views:
            raise ValueError(
                f"view {name!r} does not exist; existing views: "
                f"{sorted(self.views) or '(none)'}")
        view = self.views.pop(name)
        # queued deltas die with the view — a later drain_all or staleness
        # probe must never resurrect them
        view.pending.clear()
        self.view_set_generation += 1
        slots = np.fromiter(view.pair_slot.values(), np.int32,
                            len(view.pair_slot))
        if slots.size:
            self._set_graph(G.delete_edges(self.g, slots), {view.label_id})

    # ------------------------------------------------------ view-edge deltas

    def _apply_delta(self, view: MaterializedView, delta: DeltaPairs,
                     sign: int) -> None:
        """Apply a (src,dst,count) delta (match-path orientation) to a view."""
        if delta.src.size == 0:
            return
        # upper bound on new slots = all delta entries; reserve them upfront so
        # arena growth cannot invalidate slots handed out earlier in the loop
        g, free = self._reserve_edge_slots(self.g, int(delta.src.size))
        if g is not self.g:
            self._set_graph(g, set())
        add_slots: List[int] = []
        add_src: List[int] = []
        add_dst: List[int] = []
        add_w: List[int] = []
        upd_slots: List[int] = []
        upd_delta: List[int] = []
        free_i = 0
        for s, d, c in zip(delta.src, delta.dst, delta.count):
            key = view.oriented(int(s), int(d))
            w = int(c) * sign
            slot = view.pair_slot.get(key)
            if slot is not None:
                upd_slots.append(slot)
                upd_delta.append(w)
            elif w > 0:
                slot = int(free[free_i])
                free_i += 1
                add_slots.append(slot)
                add_src.append(key[0])
                add_dst.append(key[1])
                add_w.append(w)
                view.pair_slot[key] = slot
            # w<0 on a missing pair is only reachable in batches where a node
            # delete already killed the pair's arena edge; skipping is exact
            # (the affected-source recompute owns those rows).
        if add_slots:
            self._set_graph(
                G.create_edges(self.g, np.asarray(add_slots),
                               np.asarray(add_src), np.asarray(add_dst),
                               view.label_id, np.asarray(add_w)),
                {view.label_id})
        if upd_slots:
            self._set_graph(
                G.add_edge_weight(self.g, np.asarray(upd_slots),
                                  np.asarray(upd_delta)),
                {view.label_id})
            # drop dead pairs from the index (one pull per column)
            w = host(self.g.edge_weight)[np.asarray(upd_slots)]
            if (w <= 0).any():
                e_src = host(self.g.edge_src)
                e_dst = host(self.g.edge_dst)
                for slot, wv in zip(upd_slots, w):
                    if wv <= 0:
                        view.pair_slot.pop(
                            (int(e_src[slot]), int(e_dst[slot])), None)
        view.stats.e_vl = len(view.pair_slot)

    def _recompute_sources(self, view: MaterializedView,
                           sources: np.ndarray, metrics: Metrics,
                           ex: Optional[PathExecutor] = None) -> None:
        """Re-derive view rows for the affected sources on the current graph."""
        # current stored pairs for these sources (view-src orientation if fwd)
        desired: Dict[Tuple[int, int], int] = {}
        if sources.size:
            ex = ex or self._delta
            # explicit-source runs skip start-node filtering, so enforce the
            # match's start constraints (label/key/predicates/alive) here — a
            # property update may have moved a source out of the view's
            # predicate region, in which case its rows must all die
            start = view.vdef.match.start
            m = self.g.node_mask(
                self.schema.node_label_id(start.label), start.key)
            if start.preds:
                m = m & G.node_pred_mask(self.g, start.preds)
            m_host = host(m)
            run_sources = sources[m_host[sources]]
        if sources.size and run_sources.size:
            res = ex.run_path(view.vdef.match, counting=view.counting,
                              sources=run_sources)
            metrics += res.metrics
            s_ids, d_ids, cnt = res.pairs()
            for s, d, c in zip(s_ids, d_ids, cnt):
                desired[view.oriented(int(s), int(d))] = int(c)
        src_set = set(int(s) for s in sources)
        kill_slots: List[int] = []
        upd_slots: List[int] = []
        upd_delta: List[int] = []
        # host copies once per recompute (no mutation until after the loop)
        e_alive = host(self.g.edge_alive)
        e_weight = host(self.g.edge_weight)
        for key in list(view.pair_slot.keys()):
            ms = key[0] if view.vdef.forward else key[1]  # match-start node
            if ms not in src_set:
                continue
            slot = view.pair_slot[key]
            want = desired.pop(key, 0)
            have = int(e_weight[slot]) if e_alive[slot] else 0
            if want == 0:
                kill_slots.append(slot)
                view.pair_slot.pop(key)
            elif want != have:
                upd_slots.append(slot)
                upd_delta.append(want - have)
        if kill_slots:
            self._set_graph(G.delete_edges(self.g, np.asarray(kill_slots)),
                            {view.label_id})
        if upd_slots:
            self._set_graph(
                G.add_edge_weight(self.g, np.asarray(upd_slots),
                                  np.asarray(upd_delta)),
                {view.label_id})
        if desired:  # brand-new pairs
            keys = list(desired.keys())
            delta = DeltaPairs(
                src=np.asarray([k[0] if view.vdef.forward else k[1] for k in keys],
                               np.int32),
                dst=np.asarray([k[1] if view.vdef.forward else k[0] for k in keys],
                               np.int32),
                count=np.asarray([desired[k] for k in keys], np.int64))
            self._apply_delta(view, delta, sign=+1)
        view.stats.e_vl = len(view.pair_slot)

    # ----------------------------------------------------------- write ops

    def create_edge(self, src: int, dst: int, label: str,
                    props: Optional[Dict[str, int]] = None) -> int:
        """Create a base edge; incrementally maintain every view."""
        res = self.apply_writes(
            G.WriteBatch().create_edge(int(src), int(dst), label, props))
        return int(res.edge_slots[0])

    def delete_edge(self, edge_id: int) -> None:
        self.apply_writes(G.WriteBatch(edge_deletes=[int(edge_id)]))

    def delete_node(self, node_id: int) -> None:
        self.apply_writes(G.WriteBatch(node_deletes=[int(node_id)]))

    def create_node(self, label: str, key: Optional[int] = None) -> int:
        """Create a node (no maintenance needed; paper §IV-B).  Grows the
        node arena when full (reserve-then-grow, like the edge path)."""
        g, slots, grew = self._reserve_node_slots(self.g, 1)
        slot = int(slots[0])
        lid = self.schema.node_labels.intern(label)
        g = G.create_node(g, slot, lid, slot if key is None else int(key))
        # node growth changes node_cap (frontier/degree/adjacency shapes):
        # full engine invalidation; otherwise node writes touch no edge label
        self.engine.set_graph(g, None if grew else set())
        return slot

    def set_node_prop(self, node_id: int, prop: str, value: int) -> None:
        """Set an integer node property; maintains predicate views."""
        self.apply_writes(G.WriteBatch(
            node_prop_sets=[(int(node_id), prop, int(value))]))

    def set_edge_prop(self, edge_id: int, prop: str, value: int) -> None:
        """Set an integer edge property; maintains predicate views."""
        self.apply_writes(G.WriteBatch(
            edge_prop_sets=[(int(edge_id), prop, int(value))]))

    # ----------------------------------------------------- batched write path

    def apply_writes(self, batch: G.WriteBatch) -> BatchResult:
        """Apply a :class:`~repro_torch.core.graph.WriteBatch`, then maintain every
        view with one grouped delta pass per (view, label).

        Application order is the batch contract: edge deletes, then edge
        creates, then node creates, then node deletes.  Counting views get
        exact two-step telescoped deltas (deletes telescope old→mid, creates
        mid→new around the common mid graph); set-semantics deletes and all
        node deletes are handled by one batched affected-source recompute per
        view on the final graph.  Returns the assigned edge and node slots,
        in batch order.
        """
        metrics = Metrics()
        self.write_epoch += 1
        # exact maintenance telescopes around THIS batch from a consistent
        # pre-state: any view maintained exactly this batch must first drain
        # deltas queued while it ran under a non-exact routing
        for view in list(self.views.values()):
            if (self._effective_mode(view, batch) == "exact"
                    and not view.pending.is_empty):
                self._drain_view(view, metrics)
        g0 = self.g

        # view edges are owned by the view machinery: a user-created edge
        # carrying a view label would be invisible to wildcard queries, never
        # maintained, and orphaned by drop_view — reject before mutating
        for _, _, lbl in batch.edge_creates:
            if self.schema.is_view_edge_label(lbl):
                raise ValueError(
                    f"cannot create a base edge with view label {lbl!r}; "
                    f"view edges are maintained by create_view/apply_writes")

        # -- resolve edge deletes against g0 (dedup; dead slots are no-ops)
        e_alive0 = host(g0.edge_alive)
        e_src0 = host(g0.edge_src)
        e_dst0 = host(g0.edge_dst)
        e_lab0 = host(g0.edge_label)

        # view-edge property sets are rejected: view edges are derived state
        # whose only legitimate mutation path is view maintenance.  (Deletes
        # of view edges by arena id stay allowed — the established
        # view-label-only-write escape hatch with zero maintenance work.)
        for eid, prop, _ in batch.edge_prop_sets:
            eid = int(eid)
            if bool(e_alive0[eid]) \
                    and self.schema.is_view_edge_label_id(int(e_lab0[eid])):
                raise ValueError(
                    f"cannot set property {prop!r} on edge {eid}: it is a "
                    f"materialized view edge (maintained state)")
        del_ids: List[int] = []
        del_by_label: Dict[int, List[Tuple[int, int, int]]] = {}
        seen = set()
        for eid in batch.edge_deletes:
            eid = int(eid)
            if eid in seen or not bool(e_alive0[eid]):
                continue
            seen.add(eid)
            del_ids.append(eid)
            del_by_label.setdefault(int(e_lab0[eid]), []).append(
                (int(e_src0[eid]), int(e_dst0[eid]), eid))

        # -- step 1: edge deletes  g0 -> g1
        g1 = (G.delete_edges(g0, np.asarray(del_ids, np.int32))
              if del_ids else g0)

        # -- step 2: edge creates  g1 -> g2 (reserve-then-grow)
        create_by_label: Dict[int, List[int]] = {}
        for j, (_, _, lbl) in enumerate(batch.edge_creates):
            lid = self.schema.edge_labels.intern(lbl)
            create_by_label.setdefault(lid, []).append(j)
        g2 = g1
        created_slots = np.zeros(0, np.int32)
        if batch.edge_creates:
            g2, created_slots = self._reserve_edge_slots(
                g1, len(batch.edge_creates))
            for lid, idxs in create_by_label.items():
                g2 = G.create_edges(
                    g2, created_slots[idxs],
                    np.asarray([batch.edge_creates[j][0] for j in idxs],
                               np.int32),
                    np.asarray([batch.edge_creates[j][1] for j in idxs],
                               np.int32),
                    lid, np.ones(len(idxs), np.int32))

        # -- step 3: node creates  g2 -> g2n (no maintenance; paper §IV-B)
        g2n = g2
        created_nodes = np.zeros(0, np.int32)
        node_grew = False
        if batch.node_creates:
            g2, created_nodes, node_grew = self._reserve_node_slots(
                g2, len(batch.node_creates))
            g2n = G.create_nodes(
                g2, created_nodes,
                np.asarray([self.schema.node_labels.intern(lbl)
                            for lbl, _ in batch.node_creates], np.int32),
                np.asarray([int(created_nodes[i]) if k is None else int(k)
                            for i, (_, k) in enumerate(batch.node_creates)],
                           np.int32))

        # -- step 4: node deletes  g2n -> g3 (kills incident edges too)
        n_alive = host(g2n.node_alive)
        node_del = np.unique(np.asarray(
            [n for n in batch.node_deletes if bool(n_alive[int(n)])],
            np.int32))
        incident_labels: set = set()
        # (label id, srcs, dsts) of edges killed by node deletes — captured
        # BEFORE the delete so deferred queues record the broken endpoints
        incident_groups: List[Tuple[int, np.ndarray, np.ndarray]] = []
        g3 = g2n
        if node_del.size:
            e_alive2 = host(g2n.edge_alive)
            e_src2 = host(g2n.edge_src)
            e_dst2 = host(g2n.edge_dst)
            dead = np.zeros(g2n.node_cap, bool)
            dead[node_del] = True
            inc = e_alive2 & (dead[e_src2] | dead[e_dst2])
            inc_idx = np.flatnonzero(inc)
            inc_lab = host(g2n.edge_label)[inc_idx]
            inc_src = e_src2[inc_idx]
            inc_dst = e_dst2[inc_idx]
            for lid in np.unique(inc_lab):
                m = inc_lab == lid
                incident_groups.append((int(lid), inc_src[m], inc_dst[m]))
            incident_labels = set(lid for lid, _, _ in incident_groups)
            g3 = G.delete_nodes(g2n, node_del)

        if g3 is g0 and not batch.node_creates:
            # no structural change; property updates may still apply
            self._apply_prop_updates(batch, created_slots, created_nodes,
                                     metrics)
            self._drain_over_bound(batch, metrics)
            self.last_maintenance_metrics = metrics
            return BatchResult(created_slots, created_nodes)

        # -- engine bookkeeping: snapshot the old side BEFORE swapping, then
        # invalidate only the touched labels on the persistent engine
        touched = set(del_by_label) | set(create_by_label) | incident_labels
        old_eng = self.engine.snapshot()
        # node-arena growth changes node_cap, invalidating every shape-keyed
        # cache entry — fall back to full invalidation for this (rare) batch
        self._set_graph(g3, None if node_grew else touched)
        self._old_exec.engine = old_eng
        # mid graph (after deletes, before creates): suffix side of both
        # telescoping steps; coincides with an existing engine when possible
        if g1 is g0:
            mid_eng = old_eng
        elif g1 is g3:
            mid_eng = self.engine
        else:
            mid_eng = old_eng.snapshot(g1, set(del_by_label))
        self._mid_exec.engine = mid_eng
        # create-prefix side (after creates, before node deletes)
        if node_del.size:
            pre_eng = (old_eng if g2n is g0
                       else self.engine.snapshot(g2n, incident_labels))
        else:
            pre_eng = self.engine
        self._aux_exec.engine = pre_eng

        node_alive_final = host(g3.node_alive)
        dead_set = {int(n) for n in node_del}

        def endpoints_alive(delta: DeltaPairs) -> DeltaPairs:
            """Drop delta rows whose view-pair endpoint died in this batch
            (their arena edges are gone; recompute owns the sources)."""
            if node_del.size == 0 or delta.src.size == 0:
                return delta
            keep = (node_alive_final[delta.src]
                    & node_alive_final[delta.dst])
            return DeltaPairs(delta.src[keep], delta.dst[keep],
                              delta.count[keep])

        # (label name, srcs, dsts, eids) per delta group, shared across views
        name_of = self.schema.edge_labels.name_of
        del_groups = [
            (name_of(lid),
             np.asarray([p[0] for p in pairs], np.int32),
             np.asarray([p[1] for p in pairs], np.int32),
             np.asarray([p[2] for p in pairs], np.int32))
            for lid, pairs in del_by_label.items()]
        create_groups = [
            (name_of(lid),
             np.asarray([batch.edge_creates[j][0] for j in idxs], np.int32),
             np.asarray([batch.edge_creates[j][1] for j in idxs], np.int32),
             created_slots[idxs])
            for lid, idxs in create_by_label.items()]

        # -- per-view maintenance: one grouped pass per (view, label)
        for view in self.views.values():
            if dead_set:
                # index purge stays synchronous for every policy: arena edges
                # incident to deleted nodes are already dead, and leaving the
                # slots indexed would alias recycled slots on the next create
                for key in [k for k in view.pair_slot
                            if k[0] in dead_set or k[1] in dead_set]:
                    view.pair_slot.pop(key)
            if self._effective_mode(view, batch) != "exact":
                # non-exact policies: the base mutations above already landed,
                # so only this view's derived edges go stale.  Queue the
                # structural endpoints per label; the drain sweep re-derives
                # every affected source on the then-current graph.
                pend = view.pending
                for name, srcs, dsts, _eids in del_groups:
                    if self._uses_label(view, name):
                        pend.add_edges(name, srcs, dsts, self.write_epoch)
                for name, srcs, dsts, _eids in create_groups:
                    if self._uses_label(view, name):
                        pend.add_edges(name, srcs, dsts, self.write_epoch)
                for lid, srcs, dsts in incident_groups:
                    if self._uses_label(view, name_of(lid)):
                        pend.add_edges(name_of(lid), srcs, dsts,
                                       self.write_epoch)
                view.stats.e_vl = len(view.pair_slot)
                continue
            affected = np.zeros(0, np.int32)
            if view.counting:
                for name, srcs, dsts, eids in del_groups:
                    if not self._uses_label(view, name):
                        continue
                    delta = batch_edge_delta_pairs(
                        view.templates, view.vdef, self.schema, srcs, dsts,
                        name, counting=True, metrics=metrics,
                        ex_pre=self._old_exec, ex_suf=self._mid_exec,
                        edge_ids=eids)
                    self._apply_delta(view, endpoints_alive(delta), sign=-1)
                for name, srcs, dsts, eids in create_groups:
                    if not self._uses_label(view, name):
                        continue
                    delta = batch_edge_delta_pairs(
                        view.templates, view.vdef, self.schema, srcs, dsts,
                        name, counting=True, metrics=metrics,
                        ex_pre=self._aux_exec, ex_suf=self._mid_exec,
                        edge_ids=eids)
                    self._apply_delta(view, endpoints_alive(delta), sign=+1)
            else:
                # set semantics: deletes delimit affected sources on the old
                # graph; rows re-derive on the final graph below
                for name, srcs, dsts, eids in del_groups:
                    if not self._uses_label(view, name):
                        continue
                    aff = affected_sources_edges(
                        view.templates, view.vdef, self.schema, srcs, dsts,
                        name, metrics=metrics, ex=self._old_exec,
                        edge_ids=eids)
                    affected = np.union1d(affected, aff).astype(np.int32)
            if node_del.size:
                aff = affected_sources_nodes(
                    view.templates, view.vdef, self.schema, node_del,
                    metrics=metrics, ex=self._aux_exec)
                affected = np.union1d(affected, aff).astype(np.int32)
            if affected.size:
                affected = np.setdiff1d(affected, node_del).astype(np.int32)
            if affected.size:
                self._recompute_sources(view, affected, metrics,
                                        ex=self._delta)
            if not view.counting:
                # creates under set semantics: union-add pairs reachable
                # through the new edges, evaluated on the final graph
                for name, srcs, dsts, eids in create_groups:
                    if not self._uses_label(view, name):
                        continue
                    delta = batch_edge_delta_pairs(
                        view.templates, view.vdef, self.schema, srcs, dsts,
                        name, counting=False, metrics=metrics,
                        ex_pre=self._delta, ex_suf=self._delta,
                        edge_ids=eids)
                    self._apply_union(view, endpoints_alive(delta))
            view.stats.e_vl = len(view.pair_slot)

        # -- step 5: property updates  g3 -> g4 (the prop-update write kind)
        self._apply_prop_updates(batch, created_slots, created_nodes, metrics)

        # the snapshots are per-batch; point the wrappers back at the live
        # engine so stale graphs cannot leak into the next operation
        self._old_exec.engine = self.engine
        self._mid_exec.engine = self.engine
        self._aux_exec.engine = self.engine
        self._drain_over_bound(batch, metrics)
        self.last_maintenance_metrics = metrics
        return BatchResult(created_slots, created_nodes)

    # ------------------------------------------------- property-update pass

    def _apply_prop_updates(self, batch: G.WriteBatch,
                            edge_slots: np.ndarray, node_slots: np.ndarray,
                            metrics: Metrics) -> None:
        """Apply the batch's property sets and maintain predicate views.

        Property updates are the last step of the batch contract (after all
        structural steps), so sets may target both pre-existing elements and
        elements created by this batch (via ``edge_create_props`` /
        ``node_create_props``, resolved against the assigned slots).  A
        property update is equivalent to deleting and re-creating the touched
        element for every view whose predicates *read* the touched property;
        maintenance is one batched affected-source sweep per such view — on
        the pre-update and post-update graphs, since the element may satisfy
        the predicate on either side of the transition — followed by an
        affected-source recompute on the final graph.  Views that read none
        of the touched properties are provably unaffected and skipped.
        """
        e_sets = list(batch.edge_prop_sets) + [
            (int(edge_slots[i]), p, int(v))
            for i, p, v in batch.edge_create_props]
        n_sets = list(batch.node_prop_sets) + [
            (int(node_slots[i]), p, int(v))
            for i, p, v in batch.node_create_props]
        if not e_sets and not n_sets:
            return
        g = self.g
        e_alive = host(g.edge_alive)
        n_alive = host(g.node_alive)
        e_lab = host(g.edge_label)
        # dead targets are no-ops (the delete convention); view edges are
        # skipped defensively (pre-mutation validation already raised for
        # the cases visible at batch entry)
        e_sets = [(int(i), p, int(v)) for i, p, v in e_sets
                  if bool(e_alive[int(i)])
                  and not self.schema.is_view_edge_label_id(int(e_lab[int(i)]))]
        n_sets = [(int(i), p, int(v)) for i, p, v in n_sets
                  if bool(n_alive[int(i)])]
        if not e_sets and not n_sets:
            return

        old_eng = self.engine.snapshot()
        # last-write-wins per (element, prop): one grouped device set per prop
        by_prop_e: Dict[str, Dict[int, int]] = {}
        for i, p, v in e_sets:
            by_prop_e.setdefault(p, {})[i] = v
        by_prop_n: Dict[str, Dict[int, int]] = {}
        for i, p, v in n_sets:
            by_prop_n.setdefault(p, {})[i] = v
        for p, by_slot in by_prop_e.items():
            g = G.set_edge_props(g, list(by_slot), p, list(by_slot.values()))
        for p, by_slot in by_prop_n.items():
            g = G.set_node_props(g, list(by_slot), p, list(by_slot.values()))
        # an edge-prop write changes that label's predicate-filtered slices/
        # degrees/adjacency — bump exactly the touched labels (plan-cache
        # invalidation rides the same epochs); node props live outside the
        # engine's caches (they are per-execution operands), so node-only
        # updates touch no label
        touched_labels = {int(e_lab[i]) for i, _, _ in e_sets}
        self._set_graph(g, touched_labels)
        self._old_exec.engine = old_eng

        e_src = host(g.edge_src)
        e_dst = host(g.edge_dst)
        name_of = self.schema.edge_labels.name_of
        for view in self.views.values():
            node_read = {p.prop for n in view.vdef.match.nodes
                         for p in n.preds}
            rel_read = {p.prop for r in view.vdef.match.rels
                        for p in r.preds}
            if self._effective_mode(view, batch) != "exact":
                # queue the prop-touched elements; by drain time the
                # old-vs-new predicate membership question is moot — the
                # sweep runs with check_preds=False on the current graph
                pend = view.pending
                if rel_read:
                    q_by_label: Dict[str, List[int]] = {}
                    for i, p, _ in e_sets:
                        if p in rel_read:
                            q_by_label.setdefault(name_of(int(e_lab[i])),
                                                  []).append(i)
                    for name, eids in q_by_label.items():
                        if not self._uses_label(view, name):
                            continue
                        eids_np = np.unique(np.asarray(eids, np.int32))
                        pend.add_edges(name, e_src[eids_np], e_dst[eids_np],
                                       self.write_epoch)
                if node_read:
                    nids = np.unique(np.asarray(
                        [i for i, p, _ in n_sets if p in node_read],
                        np.int32))
                    if nids.size:
                        pend.add_nodes(nids, self.write_epoch)
                continue
            affected = np.zeros(0, np.int32)
            if rel_read:
                by_label: Dict[str, List[int]] = {}
                for i, p, _ in e_sets:
                    if p in rel_read:
                        by_label.setdefault(name_of(int(e_lab[i])),
                                            []).append(i)
                for name, eids in by_label.items():
                    if not self._uses_label(view, name):
                        continue
                    eids_np = np.unique(np.asarray(eids, np.int32))
                    srcs, dsts = e_src[eids_np], e_dst[eids_np]
                    for ex in (self._old_exec, self._delta):
                        aff = affected_sources_edges(
                            view.templates, view.vdef, self.schema,
                            srcs, dsts, name, metrics=metrics, ex=ex,
                            edge_ids=eids_np, check_preds=False)
                        affected = np.union1d(affected, aff).astype(np.int32)
            if node_read:
                nids = np.unique(np.asarray(
                    [i for i, p, _ in n_sets if p in node_read], np.int32))
                if nids.size:
                    for ex in (self._old_exec, self._delta):
                        aff = affected_sources_nodes(
                            view.templates, view.vdef, self.schema, nids,
                            metrics=metrics, ex=ex)
                        affected = np.union1d(affected, aff).astype(np.int32)
            if affected.size:
                self._recompute_sources(view, affected, metrics,
                                        ex=self._delta)
            view.stats.e_vl = len(view.pair_slot)
        self._old_exec.engine = self.engine

    def _apply_union(self, view: MaterializedView, delta: DeltaPairs) -> None:
        """Set-semantics create pass: add only pairs not already stored.

        The keep-filter is a vectorized membership test — pairs encode as
        ``src * node_cap + dst`` int64 keys (node ids < node_cap, so the
        encoding is injective) and one ``np.isin`` replaces the per-pair
        ``oriented()`` dict probes over the delta."""
        if delta.src.size == 0:
            return
        cap = np.int64(self.g.node_cap)
        s = delta.src.astype(np.int64)
        d = delta.dst.astype(np.int64)
        cand = s * cap + d if view.vdef.forward else d * cap + s
        if view.pair_slot:
            stored = np.fromiter(
                (k[0] * cap + k[1] for k in view.pair_slot),
                np.int64, len(view.pair_slot))
            keep = ~np.isin(cand, stored)
        else:
            keep = np.ones(cand.shape[0], bool)
        if not keep.any():
            return
        sub = DeltaPairs(delta.src[keep], delta.dst[keep],
                         np.ones(int(keep.sum()), np.int64))
        self._apply_delta(view, sub, sign=+1)

    def _uses_label(self, view: MaterializedView, label: str) -> bool:
        """Does a write to edges of ``label`` affect this view's match?

        A wildcard rel (``label is None``) spans *base* labels only, so
        writes to another view's label never trigger maintenance here — and a
        view can never self-maintain through its own materialized edges.
        View labels only count when the match names them explicitly (a query
        pattern over a view edge, e.g. after optimizer rewrite)."""
        if self.schema.is_view_edge_label(label):
            return any(r.label == label for r in view.vdef.match.rels)
        return any(r.label == label or r.label is None
                   for r in view.vdef.match.rels)

    # ---------------------------------------------------- freshness / drains

    def _effective_mode(self, view: MaterializedView,
                        batch: G.WriteBatch) -> str:
        """The refresh mode governing this view for this batch: the declared
        policy, unless the batch routed an override (WriteBatch.route_view)."""
        return batch.refresh_routing.get(view.name, view.vdef.refresh.mode)

    def _drain_view(self, view: MaterializedView, metrics: Metrics) -> bool:
        """Replay a view's queued deltas: one affected-source sweep per
        queued label plus one per queued node set, then a single batched
        recompute — all on the *current* graph.

        Completeness rests on a first-break argument: for any view row that
        must change, walk its derivation path from the source and take the
        first element the queued writes invalidated (or newly validated).
        Every earlier element is intact and constraint-satisfying in the
        current graph, so the reversed-prefix sweep from the queued element's
        path-side endpoint reaches the source.  Node deletes participate via
        their incident edges (endpoints captured before the delete); the
        path-side endpoint of the first broken element is alive by
        minimality.  Prop flips are queued by element with the sweep running
        ``check_preds=False``, so either-side membership is covered.
        """
        pending = view.pending
        view.drain_epoch = self.write_epoch
        if pending.is_empty:
            return False
        # a view whose match names another view's label reads those edges
        # while re-deriving: refresh dependencies first (views can only name
        # earlier-created views, so recursion terminates)
        for r in view.vdef.match.rels:
            dep = self.views.get(r.label) if r.label else None
            if dep is not None and dep is not view and not dep.pending.is_empty:
                self._drain_view(dep, metrics)
        affected = pending_affected_sources(
            pending, view.templates, view.vdef, self.schema, metrics,
            self._delta)
        pending.clear()
        if affected.size:
            self._recompute_sources(view, affected, metrics, ex=self._delta)
        view.stats.e_vl = len(view.pair_slot)
        return True

    def _drain_over_bound(self, batch: G.WriteBatch, metrics: Metrics) -> None:
        """End-of-batch backstop: a bounded-stale view whose queued lag
        exceeds its declared bound repairs immediately (write-time drain), so
        no later read can observe staleness beyond the bound."""
        for view in list(self.views.values()):
            if self._effective_mode(view, batch) != "bounded_stale":
                continue
            if view.pending.is_empty:
                continue
            bound = view.vdef.refresh.staleness
            if view.pending.staleness(self.write_epoch) > bound:
                self._drain_view(view, metrics)

    def _read_triggers_drain(self, view: MaterializedView) -> bool:
        """Would a read that touches this view have to drain it first?
        Deferred views always refresh on first conflicting read; bounded-stale
        views may answer stale while within their declared bound."""
        if view.pending.is_empty:
            return False
        pol = view.vdef.refresh
        if (pol.mode == "bounded_stale"
                and view.pending.staleness(self.write_epoch) <= pol.staleness):
            return False
        return True

    def _maybe_drain_for_query(self, q: Query, use_views: bool) -> None:
        """Pre-plan freshness pass: drain any stale view this query could
        read — directly (the query names the view label) or via an optimizer
        splice.  Cheap pattern-level check; the post-plan label check in
        :meth:`query` is the safety net for rewrites this misses."""
        stale = [v for v in self.views.values()
                 if self._read_triggers_drain(v)]
        if not stale:
            return
        from repro_torch.core.matcher import read_may_use_view
        for view in stale:
            if read_may_use_view(q.path, view.name, view.vdef.match,
                                 splice=use_views):
                self._drain_view(view, Metrics())

    def view(self, name: str) -> ViewHandle:
        """The :class:`ViewHandle` for an existing view."""
        if name not in self.views:
            raise ValueError(
                f"view {name!r} does not exist; existing views: "
                f"{sorted(self.views) or '(none)'}")
        return ViewHandle(self, name)

    def catalog(self) -> Tuple[ViewHandle, ...]:
        """Handles for every view, in creation order."""
        return tuple(ViewHandle(self, n) for n in self.views)

    def refresh(self, name: Optional[str] = None) -> bool:
        """Drain queued maintenance deltas now — one view by ``name``, or
        every view when ``name`` is None (serve fences and tests use the
        latter as the global synchronization point).  Returns True if any
        deltas were replayed."""
        metrics = Metrics()
        if name is not None:
            if name not in self.views:
                raise ValueError(f"view {name!r} does not exist")
            views = [self.views[name]]
        else:
            views = list(self.views.values())
        out = False
        for view in views:
            out = self._drain_view(view, metrics) or out
        self.last_maintenance_metrics = metrics
        return out

    # -------------------------------------------- pre-§14 drain API (shims)

    def drain_view(self, name: str) -> bool:
        """Deprecated: use :meth:`refresh` (or ``ViewHandle.drain``)."""
        warn_once("GraphSession.drain_view(name) is deprecated; use "
                  "session.refresh(name) or session.view(name).drain()")
        return self.refresh(name)

    def drain_all(self) -> None:
        """Deprecated: use :meth:`refresh` with no arguments."""
        warn_once("GraphSession.drain_all() is deprecated; use "
                  "session.refresh()")
        self.refresh()

    # ------------------------------------------------------- view selection

    def selection_stats(self):
        raise NotImplementedError(
            "view selection is not ported yet (ROADMAP A7)")

    def select_views(self, read_queries, k: int = 3, refresh=None,
                     write_fraction: float = 0.0):
        raise NotImplementedError(
            "view selection is not ported yet (ROADMAP A7)")

    # -------------------------------------------------------------- queries

    def query(self, q: Union[str, Query], use_views: Optional[bool] = None,
              sources: Optional[np.ndarray] = None) -> ReachResult:
        """Compile-once read path: fingerprint → memoized Algorithm-3 rewrite
        → cached physical plan → one fused program per source block
        (core/plan.py).
        ``last_rewrite_seconds`` is the rewrite time paid by *this* call —
        0.0 whenever the plan or rewrite cache hits.

        ``sources`` restricts evaluation to an explicit source-id array (the
        per-client binding a serving workload carries); like
        :meth:`~repro_torch.core.executor.PathExecutor.run_path`, explicit sources
        skip the start node's label/key/predicate filter — the caller owns
        the binding."""
        if isinstance(q, str):
            q = parse_query(q)
        use = self.auto_optimize if use_views is None else use_views
        self._maybe_drain_for_query(q, use)
        views = list(self.views.values()) if (use and self.views) else []
        plan, self.last_rewrite_seconds = self.planner.plan(
            q, views, self.view_set_generation)
        # post-plan safety net: the greedy rewrite fixpoint can splice in a
        # view the pre-plan pattern check missed (a view matching only a
        # partially rewritten path).  Drain any such stale view, then replan
        # — the drain bumps the view label's epoch, so the first plan is
        # invalid anyway
        drained = False
        for view in self.views.values():
            if (view.label_id in plan.label_epochs
                    and self._read_triggers_drain(view)):
                self._drain_view(view, Metrics())
                drained = True
        if drained:
            plan, rw = self.planner.plan(q, views, self.view_set_generation)
            self.last_rewrite_seconds += rw
        return plan.execute(sources=sources)

    # ------------------------------------------------------------- serving

    def serve(self, config=None):
        raise NotImplementedError(
            "the serve engine is not ported yet (ROADMAP A8)")

    # ------------------------------------------------------------ integrity

    def check_consistency(self, name: str) -> bool:
        """Paper §VI-C verification: stored view == re-derived from scratch.

        The re-derivation runs on the session engine, so a wildcard rel in
        the view's match expands over base labels only — other views'
        (and this view's own) materialized edges cannot pollute the check.
        A view under a non-exact refresh policy must be drained first
        (:meth:`drain_view`) — an undrained stale view fails by design."""
        view = self.views[name]
        res = self._exec.run_path(view.vdef.match, counting=view.counting)
        s_ids, d_ids, cnt = res.pairs()
        fresh: Dict[Tuple[int, int], int] = {}
        for s, d, c in zip(s_ids, d_ids, cnt):
            fresh[view.oriented(int(s), int(d))] = int(c)
        # one host pull of the alive mask + weights, not one device
        # round-trip per stored view row
        alive = host(self.g.edge_alive)
        weight = host(self.g.edge_weight)
        stored: Dict[Tuple[int, int], int] = {}
        for key, slot in view.pair_slot.items():
            if alive[slot]:
                stored[key] = int(weight[slot]) if view.counting else 1
        if view.counting:
            return fresh == stored
        return set(fresh.keys()) == set(stored.keys())

"""Automatic view selection from a workload (the paper's §VII future work).

The paper selects views manually; it names automatic workload-driven
selection as future work.  This module implements it with the paper's own
cost model:

1. enumerate candidate view definitions = every contiguous subpath (length
   >= 1 rel) of every read query's pattern, closed under de-duplication
   (label/direction/hop-range signature);
2. score each candidate by its *measured* ViewOptEff (Eq. 1): run the
   candidate's match once to get DBHit_noV and |E_VL|, estimate DBHit_V =
   |N_SL| + 2|E_VL|, weight by how many workload queries the candidate
   matches (Algorithm 4's matcher decides);
3. greedily take the top-k positive-benefit candidates, re-scoring after
   each pick on the rewritten queries so overlapping candidates don't
   double-count (the Figure 8-12 ordering problem, solved greedily as the
   paper proposes: "a Cost-Based Optimizer and a greedy algorithm").

The measurement layer is factored into :class:`SelectionStats`, a reusable
store that outlives a single :func:`select_views` call: the online selector
(``core/online_selection.py``) keeps one across its whole serve lifetime and
re-ranks candidates from dict hits as traffic drifts.  Measurements run
through the session's fused :class:`~repro_torch.core.plan.CompiledPlan` when a
planner is available (one fused program — the same build
path ``create_view`` uses) and each carries the plan that produced it, so a
measurement is valid exactly as long as its plan: a write touching one of
the candidate's labels invalidates precisely that candidate's numbers.  The
measured :class:`~repro_torch.core.executor.ReachResult` rides along, letting
``create_view(..., precomputed=...)`` materialize a selected view without
re-executing its match — selection *measurement* and view *creation* share
one execution.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.executor import ExecConfig, ExecEngine, PathExecutor
from repro_torch.core.matcher import match_view
from repro_torch.core.optimizer import change_pg
from repro_torch.core.parser import parse_query
from repro_torch.core.pattern import (
    FreshnessPolicy, PathPattern, Query, ViewDef, normalize_preds,
)
from repro_torch.utils import host


def maintenance_weight(refresh: FreshnessPolicy) -> float:
    """Relative per-write maintenance cost of a refresh policy (Eq. 1's
    maintenance term, DESIGN.md §11).

    Exact maintenance pays the full delta sweep on every write.  Deferred
    maintenance coalesces queued deltas per (view, label) pair and replays
    them in one batched sweep at the next conflicting read, collapsing
    delete/recreate churn — modeled as a flat coalescing discount.  A
    bounded-stale view amortizes one sweep over up to ``staleness`` queued
    writes."""
    if refresh.mode == "exact":
        return 1.0
    if refresh.mode == "deferred":
        return 0.25
    return 1.0 / (1.0 + refresh.staleness)


def _signature(path: PathPattern) -> tuple:
    return (
        tuple((n.label, n.key, normalize_preds(n.preds)) for n in path.nodes),
        tuple((r.label, r.direction, r.min_hops, r.max_hops,
               normalize_preds(r.preds))
              for r in path.rels),
    )


def _match_signature(path: PathPattern) -> tuple:
    """Canonical match identity of a path: everything ``match_view`` reads.

    Unlike :func:`_signature` this includes the ``is_referenced`` flags (the
    matcher's NodeCanMatch/RelpCanMatch consult them), so it is safe as a key
    for memoizing match probes — the same canonicalization idea the planner's
    :class:`~repro_torch.core.pattern.QueryFingerprint` applies to plans."""
    return (
        tuple((n.label, n.key, normalize_preds(n.preds), n.is_referenced)
              for n in path.nodes),
        tuple((r.label, r.direction, r.min_hops, r.max_hops,
               normalize_preds(r.preds), r.is_referenced)
              for r in path.rels),
    )


def candidate_subpaths(queries: Sequence[Query]) -> List[PathPattern]:
    """All de-duplicated contiguous subpaths with >= 1 relationship whose
    interior elements are unreferenced (spliceable by Algorithm 4)."""
    seen: Dict[tuple, PathPattern] = {}
    for q in queries:
        path = q.path
        n = len(path.rels)
        for lo in range(n):
            for hi in range(lo + 1, n + 1):
                if hi - lo == 1 and not any(
                        r.is_varlen for r in path.rels[lo:hi]):
                    # 1-hop fixed views rarely pay for themselves; allow
                    # them only as part of longer candidates
                    continue
                sub = PathPattern(nodes=path.nodes[lo:hi + 1],
                                  rels=path.rels[lo:hi])
                if any(nd.is_referenced or nd.key is not None
                       for nd in sub.nodes[1:-1]):
                    continue
                if any(r.is_referenced for r in sub.rels):
                    continue
                seen.setdefault(_signature(sub), sub)
    return list(seen.values())


@dataclass
class Measurement:
    """The graph-dependent side of one candidate's Eq. 1 score.

    ``result`` is the full :class:`~repro_torch.core.executor.ReachResult` of the
    candidate's match (match-path orientation) — ``create_view`` accepts it
    via ``precomputed=`` so materializing a measured candidate installs the
    already-computed pairs instead of re-executing.  ``plan`` is the compiled
    plan that produced it; the measurement is current exactly while the plan
    is valid (label epochs, arena shape).  Unfused (executor-made)
    measurements carry no plan and are only trusted within one greedy run —
    the legacy offline behavior."""

    e_vl: int
    n_sl: int
    db_hit_no_v: int
    result: Optional[object] = None    # ReachResult
    plan: Optional[object] = None      # CompiledPlan (validity scope)

    def is_current(self) -> bool:
        return self.plan is not None and self.plan.is_valid(0)


class SelectionStats:
    """Reusable, incrementally-maintained selection statistics.

    One instance can span many selection rounds: match probes are memoized
    on canonical signatures (graph-independent — never invalidated), and
    candidate measurements are re-validated through their plan's label
    epochs, so only candidates whose labels a write actually touched are
    re-measured.  With a ``planner``, measurement runs the fused compiled
    path (and the session's plan cache makes repeated candidate shapes
    compile-free); without one it falls back to the unfused executor.
    """

    def __init__(self, schema, *, planner=None,
                 executor: Optional[PathExecutor] = None):
        if planner is None and executor is None:
            raise ValueError("SelectionStats needs a planner or an executor")
        self.schema = schema
        self.planner = planner
        self.executor = executor
        self.match_memo: Dict[tuple, bool] = {}
        self.measurements: Dict[tuple, Measurement] = {}
        self.measures = 0        # pattern executions actually performed
        self.measure_hits = 0    # memoized measurements still current

    def match_probe(self, qpath: PathPattern, sub: PathPattern) -> bool:
        """Memoized ``match_view(qpath, sub) is not None``."""
        key = (_match_signature(qpath), _match_signature(sub))
        hit = self.match_memo.get(key)
        if hit is None:
            hit = match_view(qpath, sub) is not None
            self.match_memo[key] = hit
        return hit

    def measure(self, sub: PathPattern) -> Measurement:
        """Measured (e_vl, n_sl, db_hit_no_v) for a candidate subpath,
        re-executing only when no current measurement exists."""
        key = _signature(sub)
        m = self.measurements.get(key)
        if m is not None and (m.plan is None or m.is_current()):
            self.measure_hits += 1
            return m
        counting = not any(r.unbounded for r in sub.rels)
        if self.planner is not None:
            plan, _ = self.planner.plan(Query(path=sub), [], 0)
            res = plan.execute()
            g = self.planner.engine.g
        else:
            plan = None
            res = self.executor.run_path(sub, counting=counting)
            g = self.executor.g
        start_lid = self.schema.node_label_id(sub.start.label)
        n_sl = int(host(g.node_mask(start_lid)).sum())
        m = Measurement(e_vl=res.num_pairs(), n_sl=n_sl,
                        db_hit_no_v=res.metrics.db_hits,
                        result=res, plan=plan)
        self.measurements[key] = m
        self.measures += 1
        return m


@dataclass
class Candidate:
    vdef: ViewDef
    opt_eff: float          # Eq. 1, summed over matching workload queries
    n_matches: float
    db_hit_no_v: int
    e_vl: int
    maint_cost: float = 0.0  # policy-weighted per-write maintenance estimate
    measurement: Optional[Measurement] = None  # for create_view precomputed=


class _Probe:
    """Stats wrapper so the matcher/optimizer can rank a candidate before it
    is materialized (duck-types MaterializedView for match_view/change_pg)."""

    def __init__(self, vdef: ViewDef, opt_eff: float):
        self.vdef = vdef
        self.name = vdef.name
        self._eff = opt_eff

    class _S:
        def __init__(self, e):
            self._e = e

        def opt_eff(self):
            return self._e

    @property
    def stats(self):
        return self._S(self._eff)


def score_candidate(ex: Optional[PathExecutor], sub: PathPattern,
                    queries: Sequence[Query], name: str,
                    match_memo: Optional[Dict[tuple, bool]] = None,
                    measure_memo: Optional[Dict[tuple, tuple]] = None,
                    refresh: FreshnessPolicy = FreshnessPolicy(),
                    write_fraction: float = 0.0,
                    stats: Optional[SelectionStats] = None,
                    weights: Optional[Sequence[float]] = None
                    ) -> Optional[Candidate]:
    """Measure Eq. 1 for one candidate against the current graph.

    ``write_fraction`` is the workload's writes-per-view-read ratio; when
    nonzero the score is discounted by the policy-weighted maintenance cost
    of keeping the candidate fresh under the *deployed* ``refresh`` policy
    (one delta sweep costs on the order of the view's own optimized read,
    ``n_sl + 2 e_vl``); the returned candidate's ViewDef carries that policy
    from construction, so scoring and the materialized view never disagree.
    ``stats`` supersedes the legacy per-call ``match_memo``/``measure_memo``
    dicts with a store that can live across calls; ``weights`` (aligned with
    ``queries``) turn match counting into observed-frequency weighting — the
    online selector's live traffic view.  The defaults (exact policy,
    ``write_fraction=0``, unit weights) reproduce the pure Eq. 1 score."""
    # strip interior references for the view definition (replace() keeps
    # every other constraint — key AND property predicates)
    from dataclasses import replace as _replace
    s_var = sub.start.var or "s"
    d_var = sub.end.var or "d"
    nodes = list(sub.nodes)
    if nodes[0].var is None:
        nodes[0] = _replace(nodes[0], var=s_var)
    if nodes[-1].var is None:
        nodes[-1] = _replace(nodes[-1], var=d_var)
    sub = PathPattern(nodes=tuple(nodes), rels=sub.rels)
    vdef = ViewDef(name=name, src_var=nodes[0].var, dst_var=nodes[-1].var,
                   match=sub, refresh=refresh)
    # the measured side of Eq. 1 depends only on the graph, which greedy
    # re-scoring never mutates (candidates are not materialized) — cache it
    # per candidate signature so each round re-ranks from dict lookups
    meas: Optional[Measurement] = None
    if stats is not None:
        meas = stats.measure(sub)
        e_vl, n_sl, db_hit_no_v = meas.e_vl, meas.n_sl, meas.db_hit_no_v
    else:
        mkey = _signature(sub)
        cached = None if measure_memo is None else measure_memo.get(mkey)
        if cached is not None:
            e_vl, n_sl, db_hit_no_v = cached
        else:
            counting = not any(r.unbounded for r in sub.rels)
            res = ex.run_path(sub, counting=counting)
            e_vl = res.num_pairs()
            start_lid = ex.schema.node_label_id(sub.start.label)
            n_sl = int(host(ex.g.node_mask(start_lid)).sum())
            db_hit_no_v = res.metrics.db_hits
            if measure_memo is not None:
                measure_memo[mkey] = (e_vl, n_sl, db_hit_no_v)
    per_use_eff = db_hit_no_v - (n_sl + 2 * e_vl)        # Eq. 1
    maint_cost = (write_fraction * maintenance_weight(refresh)
                  * (n_sl + 2 * e_vl))
    per_use_eff -= maint_cost
    if stats is not None:
        n_matches = 0.0
        for i, q in enumerate(queries):
            if stats.match_probe(q.path, sub):
                n_matches += 1.0 if weights is None else float(weights[i])
    elif match_memo is None:
        n_matches = sum((1.0 if weights is None else float(weights[i]))
                        for i, q in enumerate(queries)
                        if match_view(q.path, sub) is not None)
    else:
        # greedy re-scoring probes every (candidate, live query) pair per
        # round; memoize on canonical match signatures so unchanged pairs
        # (most queries survive a pick un-rewritten) are dict hits
        csig = _match_signature(sub)
        n_matches = 0.0
        for i, q in enumerate(queries):
            mkey = (_match_signature(q.path), csig)
            hit = match_memo.get(mkey)
            if hit is None:
                hit = match_view(q.path, sub) is not None
                match_memo[mkey] = hit
            if hit:
                n_matches += 1.0 if weights is None else float(weights[i])
    if n_matches == 0:
        return None
    return Candidate(vdef=vdef, opt_eff=per_use_eff * n_matches,
                     n_matches=n_matches, db_hit_no_v=db_hit_no_v,
                     e_vl=e_vl, maint_cost=maint_cost, measurement=meas)


def greedy_select(stats: SelectionStats, queries: Sequence[Query], *,
                  schema, k: int = 3,
                  refresh: FreshnessPolicy = FreshnessPolicy(),
                  write_fraction: float = 0.0,
                  weights: Optional[Sequence[float]] = None,
                  storage_budget: Optional[int] = None,
                  maintenance_budget: Optional[float] = None,
                  exclude_sigs: frozenset = frozenset(),
                  name_prefix: str = "AUTO_V") -> List[Candidate]:
    """The greedy Eq. 1 selection core, over a reusable stats store.

    Returns the chosen :class:`Candidate` s (each carrying its measurement
    for creation reuse) in pick order.  ``storage_budget`` bounds the summed
    ``e_vl`` (materialized view edges) of the picks; ``maintenance_budget``
    bounds their summed policy-weighted maintenance cost — the online
    selector's resource envelope.  ``exclude_sigs`` drops candidates by
    match signature — already-materialized (e.g. user-owned) views whose
    savings are realized and must not consume slots or budget.  After each
    pick the live workload is rewritten as if the view existed, so
    overlapping candidates don't double-count the same savings."""
    # workload queries may already reference view edges (e.g. pre-rewritten
    # patterns); a view over another view's label is not maintainable, so
    # the base/view partition filters those candidates out.  Wildcard-rel
    # candidates are fine: they expand over base labels only.
    candidates = [s for s in candidate_subpaths(queries)
                  if not any(r.label is not None
                             and schema.is_view_edge_label(r.label)
                             for r in s.rels)]
    remaining = {sig: s for s in candidates
                 if (sig := _signature(s)) not in exclude_sigs}
    live_queries = list(queries)
    live_weights = None if weights is None else list(weights)
    chosen: List[Candidate] = []
    storage_used = 0
    maint_used = 0.0
    while len(chosen) < k and remaining:
        scored: List[Candidate] = []
        for sig, sub in remaining.items():
            c = score_candidate(None, sub, live_queries,
                                name=f"{name_prefix}{len(chosen)}",
                                stats=stats, refresh=refresh,
                                write_fraction=write_fraction,
                                weights=live_weights)
            if c is None or c.opt_eff <= 0:
                continue
            if (storage_budget is not None
                    and storage_used + c.e_vl > storage_budget):
                continue
            if (maintenance_budget is not None
                    and maint_used + c.maint_cost > maintenance_budget):
                continue
            scored.append(c)
        if not scored:
            break
        best = max(scored, key=lambda c: c.opt_eff)
        chosen.append(best)
        storage_used += best.e_vl
        maint_used += best.maint_cost
        remaining.pop(_signature(best.vdef.match), None)
        # greedy re-scoring: rewrite the workload as if the view existed, so
        # overlapping candidates don't double-count the same savings
        probe = _Probe(best.vdef, best.opt_eff)
        new_qs = []
        for q in live_queries:
            path = q.path
            m = match_view(path, best.vdef.match)
            while m is not None:
                path = change_pg(path, m, probe)
                m = match_view(path, best.vdef.match)
            new_qs.append(Query(path=path, returns=q.returns))
        live_queries = new_qs
    return chosen


def select_views(g, schema, read_queries: Sequence[str], k: int = 3,
                 cfg: Optional[ExecConfig] = None,
                 engine: Optional[ExecEngine] = None,
                 refresh: FreshnessPolicy = FreshnessPolicy(),
                 write_fraction: float = 0.0,
                 planner=None,
                 stats: Optional[SelectionStats] = None) -> List[ViewDef]:
    """Greedy top-k workload-driven view selection (measured Eq. 1 scores).

    Pass a session's :class:`ExecEngine` as ``engine`` to score candidates on
    the already-warm per-label caches instead of rebuilding them; candidate
    probes are pure reads, so the engine state they leave behind (warmed
    slices) stays valid for the session.  Passing the session's ``planner``
    (or a prebuilt ``stats``) upgrades measurement to the fused compiled
    path.  ``refresh``/``write_fraction`` thread the freshness-policy
    maintenance term through every candidate score (see
    :func:`score_candidate`); selected definitions carry the policy, so
    materializing them creates views under it."""
    queries = [parse_query(q) for q in read_queries]
    if stats is None:
        executor = None
        if planner is None:
            if engine is not None:
                executor = PathExecutor(
                    engine=engine, cfg=cfg or ExecConfig(collect_metrics=True))
            else:
                executor = PathExecutor(g, schema,
                                        cfg or ExecConfig(collect_metrics=True))
        stats = SelectionStats(schema, planner=planner, executor=executor)
    chosen = greedy_select(stats, queries, schema=schema, k=k,
                           refresh=refresh, write_fraction=write_fraction)
    return [c.vdef for c in chosen]

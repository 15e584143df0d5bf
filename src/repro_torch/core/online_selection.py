"""Online, self-funding view selection from live serve statistics.

Offline selection (``core/selection.py``) answers "which views, given this
workload?" once, before traffic starts, and pays for each selected view
twice: one unfused execution to score it and another to build it.  This
module closes the loop the way Automatic View Selection in Graph Databases
(arXiv 2105.09160) proposes and prices creation the way Kaskade (arXiv
1906.05162) argues it must be priced — as part of the workload:

* the :class:`~repro_torch.serve.engine.ServeEngine` feeds every answered read
  (its fingerprint and its measured per-query DBHit) and every applied write
  fence into an :class:`OnlineSelector`;
* the selector maintains exponentially-decayed fingerprint frequencies and
  a live writes-per-read ratio, and periodically re-ranks Eq. 1 candidate
  scores through the session's persistent
  :class:`~repro_torch.core.selection.SelectionStats` — candidate measurements are
  fused one-shot executions, memoized and re-validated by their plan's label
  epochs, so a quiescent evaluation round is mostly dict lookups;
* under a configurable storage (materialized edges) and maintenance
  (policy-weighted write cost) budget it converges the set of selector-owned
  views (``name_prefix``-named; user views are never touched) toward the
  greedy Eq. 1 optimum for the *observed* traffic, creating newly profitable
  views and dropping ones whose traffic faded;
* creation reuses the scoring measurement's :class:`ReachResult` via
  ``create_view(..., precomputed=...)`` — one fused execution funds both the
  decision and the build.

The selector never initiates graph mutation on its own: the serve engine
invokes :meth:`maybe_evaluate` only between windows / after fences, i.e. at
the quiescent points where the single-writer contract already allows
``create_view``/``drop_view``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from repro_torch.core.parser import query_fingerprint
from repro_torch.core.pattern import FreshnessPolicy, Query
from repro_torch.core.selection import _signature, greedy_select


@dataclass
class OnlineSelectionConfig:
    """Budget and cadence knobs for the online selection loop."""

    max_views: int = 3               # cap on selector-owned views
    storage_budget_edges: Optional[int] = None   # sum of view |E_VL|
    maintenance_budget: Optional[float] = None   # sum of weighted write cost
    min_observations: int = 32       # reads before the first evaluation
    evaluate_every: int = 64         # reads between evaluations
    min_uses: float = 2.0            # decayed frequency floor for candidacy
    decay: float = 0.5               # per-evaluation frequency decay
    refresh: FreshnessPolicy = field(default_factory=FreshnessPolicy)
    name_prefix: str = "AUTO_OL_"    # owned-view namespace


@dataclass
class OnlineSelectionStats:
    """Cumulative counters (the serve layer reports these)."""

    reads_observed: int = 0
    writes_observed: int = 0
    evaluations: int = 0
    creates: int = 0
    drops: int = 0
    reused_builds: int = 0     # creations that installed the scoring result
    select_seconds: float = 0.0   # candidate scoring + greedy ranking
    create_seconds: float = 0.0   # view materialization (incl. reuse installs)
    actions: List[str] = field(default_factory=list)


class OnlineSelector:
    """Maintains Eq. 1 scores incrementally from observed traffic and keeps
    the selector-owned view set greedy-optimal under budget.

    Thread/write discipline: ``observe_*`` are pure bookkeeping (safe
    anywhere); :meth:`maybe_evaluate`/:meth:`evaluate` mutate the session
    catalog and must only run at quiescent points (between serve windows,
    after fences) — the caller owns that contract.
    """

    def __init__(self, session, config: Optional[OnlineSelectionConfig] = None):
        self.sess = session
        self.cfg = config or OnlineSelectionConfig()
        self.stats = OnlineSelectionStats()
        self.store = session.selection_stats()   # persistent SelectionStats
        self._freq: Dict[object, float] = {}     # fingerprint -> decayed uses
        self._rep: Dict[object, Query] = {}      # fingerprint -> exemplar
        self._db_hit: Dict[object, float] = {}   # fingerprint -> decayed DBHit
        self._reads = 0.0          # decayed read count (write_fraction denom)
        self._writes = 0.0         # decayed write-op count
        self._since_eval = 0
        self._seq = 0              # monotonic owned-view name sequence

    # ---------------------------------------------------------- observation

    def observe_read(self, q: Query, db_hits: int = 0) -> None:
        """Record one answered read: its canonical fingerprint drives the
        frequency weighting, its measured DBHit gates candidacy (a shape
        that never touches storage cannot fund a view)."""
        fp = query_fingerprint(q, self.sess.schema)
        self._freq[fp] = self._freq.get(fp, 0.0) + 1.0
        self._db_hit[fp] = self._db_hit.get(fp, 0.0) + float(db_hits)
        self._rep.setdefault(fp, q)
        self._reads += 1.0
        self.stats.reads_observed += 1
        self._since_eval += 1

    def observe_write(self, n_ops: int = 1) -> None:
        self._writes += float(n_ops)
        self.stats.writes_observed += n_ops

    @property
    def write_fraction(self) -> float:
        """Live writes-per-read ratio (both sides decayed at the same rate,
        so the ratio tracks the recent mix)."""
        return self._writes / max(self._reads, 1.0)

    # ----------------------------------------------------------- evaluation

    def maybe_evaluate(self) -> bool:
        """Run an evaluation round if enough traffic accumulated.  Called by
        the serve engine at quiescent points; returns True if a round ran."""
        if self.stats.reads_observed < self.cfg.min_observations:
            return False
        if self._since_eval < self.cfg.evaluate_every:
            return False
        self.evaluate()
        return True

    def owned_views(self) -> Dict[str, object]:
        pre = self.cfg.name_prefix
        return {n: v for n, v in self.sess.views.items() if n.startswith(pre)}

    def evaluate(self) -> Dict[str, List[str]]:
        """One selection round: re-rank candidates for the observed traffic
        and converge the owned view set to the greedy pick (drops first,
        then creates — drops free budget the creates may need).  Returns
        ``{"created": [...], "dropped": [...]}``."""
        sess, cfg = self.sess, self.cfg
        self._since_eval = 0
        self.stats.evaluations += 1

        # Eq. 1 inputs for already-owned views are maintained incrementally:
        # |E_VL| is the live materialized pair count (maintenance keeps it
        # current through writes), DBHit_noV is retained from the funding
        # measurement.  Patching the store entry (plan=None => permanently
        # current) means base writes never force a re-execution just to
        # re-rank a view we already maintain; the entry is evicted on drop
        # so a returning shape is measured afresh.
        for name, v in self.owned_views().items():
            sig = _signature(v.vdef.match)
            old = self.store.measurements.get(sig)
            if old is not None:
                self.store.measurements[sig] = replace(
                    old, e_vl=len(v.pair_slot), result=None, plan=None)

        queries: List[Query] = []
        weights: List[float] = []
        for fp, f in self._freq.items():
            if f >= cfg.min_uses and self._db_hit.get(fp, 0.0) > 0.0:
                queries.append(self._rep[fp])
                weights.append(f)

        # user-owned views already realize their savings: their signatures
        # are excluded so the selector neither duplicates them nor spends
        # slots/budget on them — and never drops them (drop scans owned only)
        user_sigs = frozenset(
            _signature(v.vdef.match) for name, v in sess.views.items()
            if not name.startswith(cfg.name_prefix))
        t0 = time.perf_counter()
        chosen = greedy_select(
            self.store, queries, schema=sess.schema, k=cfg.max_views,
            refresh=cfg.refresh, write_fraction=self.write_fraction,
            weights=weights, storage_budget=cfg.storage_budget_edges,
            maintenance_budget=cfg.maintenance_budget,
            exclude_sigs=user_sigs,
            name_prefix=cfg.name_prefix) if queries else []
        self.stats.select_seconds += time.perf_counter() - t0

        desired = {_signature(c.vdef.match): c for c in chosen}
        owned = {_signature(v.vdef.match): name
                 for name, v in self.owned_views().items()}

        dropped: List[str] = []
        for sig, name in owned.items():
            if sig not in desired:
                sess.drop_view(name)
                self.store.measurements.pop(sig, None)
                dropped.append(name)
                self.stats.drops += 1
                self.stats.actions.append(f"drop {name}")

        created: List[str] = []
        t0 = time.perf_counter()
        for sig, cand in desired.items():
            if sig in owned:
                continue
            vdef = replace(cand.vdef, name=f"{cfg.name_prefix}{self._seq}")
            self._seq += 1
            reused = (cand.measurement is not None
                      and cand.measurement.is_current())
            sess.create_view(vdef, precomputed=cand.measurement)
            created.append(vdef.name)
            self.stats.creates += 1
            self.stats.reused_builds += int(reused)
            self.stats.actions.append(
                f"create {vdef.name}{' (reused measurement)' if reused else ''}")
        self.stats.create_seconds += time.perf_counter() - t0

        # decay: recent traffic dominates the next round; shapes that faded
        # below a working epsilon stop being re-ranked at all
        d = cfg.decay
        self._reads *= d
        self._writes *= d
        for fp in list(self._freq):
            self._freq[fp] *= d
            self._db_hit[fp] = self._db_hit.get(fp, 0.0) * d
            if self._freq[fp] < 1e-3:
                del self._freq[fp]
                self._rep.pop(fp, None)
                self._db_hit.pop(fp, None)
        return {"created": created, "dropped": dropped}

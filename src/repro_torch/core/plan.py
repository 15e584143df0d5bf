"""Compiled query plans + session plan cache: fingerprint → rewrite → physical.

A :class:`QueryPlanner` compiles a query once into a cached
:class:`CompiledPlan` and repeats only tensor work:

1. **normalize + fingerprint** — :func:`repro_torch.core.parser.query_fingerprint`
   erases variable spelling and resolves labels to schema ids, giving a
   :class:`~repro_torch.core.pattern.QueryFingerprint` cache key;
2. **memoized rewrite** — the Algorithm-3 rewrite is cached per
   ``(fingerprint, view-set generation)``; ``create_view``/``drop_view``
   bump the generation;
3. **physical planning** — each hop picks its backend (``segment`` scatter,
   ``dense`` fp32 product, or the hand-written ``block_spmm`` kernel) from
   cached per-label edge counts;
4. **fused execution** — one method walks the whole step list per source
   block, with DBHit/Rows accumulated as per-row device vectors and synced
   once per block instead of once per hop.

**Invalidation.** A cached plan revalidates against the label epochs of
every edge label it touches (wildcard hops key off the base generation),
the epochs' ``reset_generation``, the node capacity, the config snapshot
and — for plans whose rewrite consulted the view catalog — the session's
view-set generation.  Operand tensors are re-fetched from the engine on
every execution, so a valid plan always runs against current data.

DBHit/Rows parity with the per-hop :class:`~repro_torch.core.executor.PathExecutor`
is exact: the program reuses the executor's hop functions in the same order,
and bounded hops past an empty frontier add exactly zero to both counters.
An unbounded closure is a host loop with the reference's
``max_closure_iters`` bound and convergence flag; its DBHit telescopes to
one multiply-sum over the converged reach set.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.executor import (
    ExecConfig, ExecEngine, Metrics, ReachResult, _active_rows_per_source,
    _hop_cost_per_source, _hop_dense, _hop_kernel, _hop_segment,
    _init_frontier,
)
from repro_torch.core.graph import node_pred_mask
from repro_torch.core.parser import query_fingerprint
from repro_torch.core.pattern import (
    Direction, PathPattern, PropPred, Query, QueryFingerprint, _cmp,
    normalize_preds,
)
from repro_torch.core.schema import GraphSchema, NO_LABEL
from repro_torch.utils import INF_HOPS, host, round_up


# ---------------------------------------------------------------------------
# physical plan IR
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExpandStep:
    """One relationship expansion: hop range over one edge label.

    ``preds`` is the rel's normalized predicate conjunction, compiled into
    the hop's edge mask / adjacency by the engine's (label, preds) caches."""

    label_id: int
    reverses: Tuple[bool, ...]      # per-direction reverse flags (BOTH = 2)
    min_hops: int
    max_hops: int                   # INF_HOPS for unbounded closure
    backend: str                    # "segment" | "dense" | "kernel"
    preds: Tuple[PropPred, ...] = ()


@dataclass(frozen=True)
class FilterStep:
    """Node label/key/predicate mask applied after an expansion.  Node
    property columns are per-execution operands (no engine epoch tracks
    them), so a node-prop write never stales a plan."""

    label_id: int
    key: Optional[int]
    preds: Tuple[PropPred, ...] = ()


def _choose_backend(engine: ExecEngine, cfg: ExecConfig, label_id: int) -> str:
    """Per-hop physical backend from cached degree/selectivity stats.

    Go dense (the kernel if ``use_kernel``) when E_label / node_cap^2 >=
    ``cfg.dense_density`` and node_cap <= ``cfg.dense_node_limit``;
    ``cfg.plan_backend`` forces a backend when not "auto", and the unfused
    ``backend="dense"`` setting forces dense hops as well.
    """
    mode = cfg.plan_backend
    if mode and mode != "auto":
        return mode
    if cfg.backend == "dense":
        return "kernel" if cfg.use_kernel else "dense"
    n = engine.g.node_cap
    if n > cfg.dense_node_limit:
        return "segment"
    e = engine.label_edge_count(label_id)
    if e >= cfg.dense_density * n * n:
        return "kernel" if cfg.use_kernel else "dense"
    return "segment"


def _cfg_snapshot(cfg: ExecConfig) -> tuple:
    """The ExecConfig fields a compiled plan depends on; plans revalidate
    against it so in-place cfg mutation takes effect on the next query."""
    return (cfg.plan_backend, cfg.backend, cfg.use_kernel,
            cfg.collect_metrics, cfg.max_closure_iters, cfg.src_block,
            cfg.dense_node_limit, cfg.dense_density)


def block_sizes(rows: int, blk: int) -> List[int]:
    """Frontier-block launch plan for ``rows`` packed source rows: whole
    ``blk`` blocks, at least one.  (The serve engine's adaptive sub-block
    sizing comes with it, ROADMAP A8.)"""
    r_pad = max(round_up(max(rows, 1), blk), blk)
    return [blk] * (r_pad // blk)


@dataclass
class RowResult:
    """Per-source-row outputs of one executed binding: the dense reach rows
    plus the per-row DBHit/Rows vectors, so the rows of each query packed
    into one batch are attributed exactly."""

    sources: np.ndarray    # [S] int32 source ids, in binding order
    reach: np.ndarray      # [S, N] int32 reach rows
    db_vec: np.ndarray     # [S] int64 per-row DBHit contributions
    rows_vec: np.ndarray   # [S] int64 per-row Rows contributions
    counting: bool

    def to_reach_result(self) -> ReachResult:
        """The :class:`ReachResult` a solo ``execute`` returns: S + the
        row-vector sums."""
        S = int(self.sources.shape[0])
        return ReachResult(
            src_ids=self.sources, reach=self.reach, counting=self.counting,
            metrics=Metrics(db_hits=S + int(self.db_vec.sum()),
                            rows=S + int(self.rows_vec.sum())))


# ---------------------------------------------------------------------------
# compiled plan
# ---------------------------------------------------------------------------

class CompiledPlan:
    """A physical plan compiled from a (rewritten) path pattern: the step
    list plus the validity snapshot (label epochs, reset generation, node
    capacity, view-set generation, config)."""

    def __init__(self, engine: ExecEngine, cfg: ExecConfig,
                 path: PathPattern, counting: bool,
                 fingerprint: QueryFingerprint, view_gen: Optional[int]):
        self.engine = engine
        self.cfg = cfg
        self.path = path
        self.counting = counting
        self.fingerprint = fingerprint
        self.view_gen = view_gen          # None: rewrite never saw the catalog
        schema = engine.schema
        start = path.start
        self.start_label_id = schema.node_label_id(start.label)
        self.start_key = start.key
        self.start_preds = normalize_preds(start.preds)
        self.steps: List[object] = []
        for i, rel in enumerate(path.rels):
            lid = schema.edge_label_id(rel.label)
            revs = ((False,) if rel.direction is Direction.OUT
                    else (True,) if rel.direction is Direction.IN
                    else (False, True))
            self.steps.append(ExpandStep(
                label_id=lid, reverses=revs, min_hops=rel.min_hops,
                max_hops=rel.max_hops,
                backend=_choose_backend(engine, cfg, lid),
                preds=normalize_preds(rel.preds)))
            nxt = path.nodes[i + 1]
            self.steps.append(FilterStep(
                label_id=schema.node_label_id(nxt.label), key=nxt.key,
                preds=normalize_preds(nxt.preds)))
        # node property columns the filters read, in a fixed order
        self._nprop_names: Tuple[str, ...] = tuple(sorted(
            {p.prop for s in self.steps if isinstance(s, FilterStep)
             for p in s.preds}))
        self.label_epochs: Dict[int, int] = {
            s.label_id: engine.epochs.of(s.label_id)
            for s in self.steps if isinstance(s, ExpandStep)}
        self.reset_gen = engine.epochs.reset_generation
        self.node_cap = engine.g.node_cap
        self._cfg_key = _cfg_snapshot(cfg)

    # -- validity ----------------------------------------------------------

    def is_valid(self, view_gen: int) -> bool:
        eng = self.engine
        if self.node_cap != eng.g.node_cap:
            return False
        if self.reset_gen != eng.epochs.reset_generation:
            return False
        if self.view_gen is not None and self.view_gen != view_gen:
            return False
        if self._cfg_key != _cfg_snapshot(self.cfg):
            return False    # session cfg mutated since compile
        return all(eng.epochs.of(lid) == ep
                   for lid, ep in self.label_epochs.items())

    # -- the program -------------------------------------------------------

    def _program(self, ids, node_label, node_key, node_alive, nprops,
                 operands):
        """The whole query for one source block.

        ``ids`` is the padded [blk] source-id block (-1 = padding); ``nprops``
        the node property columns the filters read (``self._nprop_names``
        order); ``operands`` one per-direction tuple per expand step.
        Returns (F, db[blk], rows[blk], converged) with int64 per-row metric
        vectors: every hop is row-local, so a row range's sum is exactly what
        the unfused executor accumulates for those sources.
        """
        counting = self.counting
        collect = self.cfg.collect_metrics
        blk = ids.shape[0]
        F = _init_frontier(ids, node_label.shape[0], counting)
        db = torch.zeros(blk, dtype=torch.int64, device=ids.device)
        rows = torch.zeros(blk, dtype=torch.int64, device=ids.device)
        ok = True

        def hop(Fc, step_ops, backend, reverses, db, rows, skip_db=False):
            """One expansion hop: mirrors PathExecutor._hop exactly."""
            out = None
            for rev, arrs in zip(reverses, step_ops):
                if collect and not skip_db:
                    # deg is the last operand of every backend's tuple
                    db = db + _hop_cost_per_source(Fc, arrs[-1])
                if backend == "segment":
                    esrc, edst, ew, emask, _ = arrs
                    nxt = _hop_segment(Fc, esrc, edst, emask, ew,
                                       counting=counting, reverse=rev)
                else:
                    fn = _hop_kernel if backend == "kernel" else _hop_dense
                    nxt = fn(Fc, arrs[0], counting=counting)
                out = nxt if out is None else (
                    out + nxt if counting else out | nxt)
            if collect:
                rows = rows + _active_rows_per_source(out)
            return out, db, rows

        op_i = 0
        for step in self.steps:
            if isinstance(step, FilterStep):
                m = node_alive
                if step.label_id != NO_LABEL:
                    m = m & (node_label == step.label_id)
                if step.key is not None:
                    m = m & (node_key == step.key)
                for p in step.preds:
                    m = m & _cmp(nprops[self._nprop_names.index(p.prop)],
                                 p.op, p.value)
                F = (torch.where(m[None, :], F, 0) if counting
                     else F & m[None, :])
                continue
            step_ops = operands[op_i]
            op_i += 1
            lo, hi = step.min_hops, step.max_hops
            if hi != INF_HOPS:
                # bounded: acc = sum/or over k in [lo, hi] (lo may be 0).
                # Hops past an empty frontier contribute zero to F and both
                # metrics, so no early break is needed for exactness.
                acc = F if lo == 0 else None
                cur = F
                for k in range(1, hi + 1):
                    cur, db, rows = hop(cur, step_ops, step.backend,
                                        step.reverses, db, rows)
                    if k >= lo:
                        acc = cur if acc is None else (
                            acc + cur if counting else acc | cur)
                F = acc if acc is not None else torch.zeros_like(F)
                continue
            # unbounded boolean closure: a host loop with the same iteration
            # bound and convergence flag as the reference's while_loop
            cur = F
            for _ in range(max(lo, 0)):
                cur, db, rows = hop(cur, step_ops, step.backend,
                                    step.reverses, db, rows)
            reach, frontier = cur, cur
            i = 0
            while i < self.cfg.max_closure_iters and bool(frontier.any()):
                nxt, db, rows = hop(frontier, step_ops, step.backend,
                                    step.reverses, db, rows, skip_db=True)
                reach, frontier = reach | nxt, nxt & ~reach
                i += 1
            ok = ok and not bool(frontier.any())
            if collect:
                # Successive closure frontiers are pairwise disjoint with
                # union equal to the converged reach set, so the
                # per-iteration DBHit sum telescopes to one multiply-sum over
                # ``reach``.  A non-converged exit over-counts the residual
                # frontier, but execute_rows raises before it surfaces.
                for arrs in step_ops:
                    db = db + _hop_cost_per_source(reach, arrs[-1])
            F = reach
        return F, db, rows, ok

    # -- operands ----------------------------------------------------------

    def _gather_operands(self):
        """Fetch current operands from the engine (epoch-checked lookups:
        warm entries are dict hits)."""
        eng = self.engine
        out = []
        for step in self.steps:
            if not isinstance(step, ExpandStep):
                continue
            per_dir = []
            for rev in step.reverses:
                deg = eng.deg(step.label_id, rev, step.preds)
                if step.backend == "segment":
                    esrc, edst, ew, emask = eng.label_edges(step.label_id,
                                                            step.preds)
                    per_dir.append((esrc, edst, ew, emask, deg))
                else:
                    per_dir.append((eng.adj(step.label_id, self.counting,
                                            rev, step.preds), deg))
            out.append(tuple(per_dir))
        return tuple(out)

    # -- execution ---------------------------------------------------------

    def default_sources(self) -> np.ndarray:
        """Source node ids selected by the plan's start constraints on the
        *current* graph."""
        g = self.engine.g
        src_mask = g.node_mask(self.start_label_id, self.start_key)
        if self.start_preds:
            src_mask = src_mask & node_pred_mask(g, self.start_preds)
        return np.flatnonzero(host(src_mask)).astype(np.int32)

    def execute(self, sources: Optional[np.ndarray] = None) -> ReachResult:
        """Run the plan over blocked sources.  Explicit ``sources`` skip the
        start label/key/predicate filter (the caller owns the binding)."""
        if sources is None:
            sources = self.default_sources()
        return self.execute_batch([np.asarray(sources, np.int32)])[0]

    def execute_batch(self, source_lists: Sequence[np.ndarray]
                      ) -> List[ReachResult]:
        """Run many same-plan queries as one stacked frontier batch; each
        query's metrics are exactly what a solo :meth:`execute` reports."""
        return [rr.to_reach_result()
                for rr in self.execute_rows(source_lists)]

    def execute_rows(self, source_lists: Sequence[np.ndarray]
                     ) -> List[RowResult]:
        """:meth:`execute_batch` without the per-query metric folding."""
        g = self.engine.g
        counts = [int(np.asarray(s).shape[0]) for s in source_lists]
        R = sum(counts)
        sizes = block_sizes(R, self.cfg.src_block)
        padded = np.full(sum(sizes), -1, np.int32)
        if R:
            padded[:R] = np.concatenate(
                [np.asarray(s, np.int32) for s in source_lists])
        nprops = tuple(g.node_prop_col(name) for name in self._nprop_names)
        operands = self._gather_operands()

        out_rows, db_parts, row_parts = [], [], []
        converged = True
        b0 = 0
        for blk in sizes:
            ids = torch.from_numpy(padded[b0:b0 + blk]).to(g.device)
            F, db, rows, ok = self._program(ids, g.node_label, g.node_key,
                                            g.node_alive, nprops, operands)
            out_rows.append(host(F))
            db_parts.append(host(db))
            row_parts.append(host(rows))
            converged = converged and ok
            b0 += blk
        if not converged:
            raise RuntimeError(
                "closure did not converge within max_closure_iters")
        reach = np.concatenate(out_rows, axis=0)[:R].astype(np.int32)
        db_vec = np.concatenate(db_parts)[:R]
        rows_vec = np.concatenate(row_parts)[:R]
        results: List[RowResult] = []
        off = 0
        for srcs, S in zip(source_lists, counts):
            results.append(RowResult(
                sources=np.asarray(srcs, np.int32),
                reach=reach[off:off + S], db_vec=db_vec[off:off + S],
                rows_vec=rows_vec[off:off + S], counting=self.counting))
            off += S
        return results


# ---------------------------------------------------------------------------
# planner: the session plan cache
# ---------------------------------------------------------------------------

class QueryPlanner:
    """Session-lifetime owner of the rewrite cache and the plan cache.

    ``plan(q, views, view_gen)`` is the whole compile pipeline; both caches
    key off the query fingerprint.  ``plan_hits`` / ``plan_misses`` and
    ``rewrite_hits`` / ``rewrite_misses`` make the caching observable.
    """

    def __init__(self, engine: ExecEngine, schema: GraphSchema,
                 cfg: Optional[ExecConfig] = None):
        self.engine = engine
        self.schema = schema
        self.cfg = cfg or engine.cfg
        self._plans: Dict[Tuple[QueryFingerprint, bool], CompiledPlan] = {}
        self._rewrites: Dict[Tuple[QueryFingerprint, int],
                             Tuple[PathPattern, bool]] = {}
        self.plan_hits = 0
        self.plan_misses = 0
        self.rewrite_hits = 0
        self.rewrite_misses = 0

    def plan(self, q: Query, views: Sequence, view_gen: int
             ) -> Tuple[CompiledPlan, float]:
        """Fingerprint → (memoized) rewrite → (cached) physical plan.
        Returns ``(plan, rewrite_seconds spent on this call)``."""
        fp = query_fingerprint(q, self.schema)
        use_views = bool(views)
        key = (fp, use_views)
        cached = self._plans.get(key)
        if cached is not None and cached.is_valid(view_gen):
            self.plan_hits += 1
            return cached, 0.0
        self.plan_misses += 1
        rewrite_s = 0.0
        if use_views:
            rw = self._rewrites.get((fp, view_gen))
            if rw is not None:
                self.rewrite_hits += 1
                path, force_bool = rw
            else:
                self.rewrite_misses += 1
                from repro_torch.core.optimizer import optimize_query
                t0 = time.perf_counter()
                q_rw = optimize_query(q, list(views))
                rewrite_s = time.perf_counter() - t0
                path, force_bool = q_rw.path, q_rw.force_bool
                # superseded generations are unreachable: prune them
                if any(k[1] != view_gen for k in self._rewrites):
                    self._rewrites = {k: v for k, v in self._rewrites.items()
                                      if k[1] == view_gen}
                self._rewrites[(fp, view_gen)] = (path, force_bool)
        else:
            path, force_bool = q.path, q.force_bool
        counting = (not force_bool
                    and not any(r.unbounded for r in path.rels))
        plan = CompiledPlan(self.engine, self.cfg, path, counting,
                            fingerprint=fp,
                            view_gen=view_gen if use_views else None)
        self._plans[key] = plan
        return plan, rewrite_s

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

**The serve path.** :meth:`CompiledPlan.execute_rows` returns per-row
:class:`RowResult` s (memoized and gathered by the serve engine) and, with
``adaptive_blocks``, sizes a small batch to a power-of-two block.  Plans
with equal :meth:`CompiledPlan.structure_key` (all-segment, same step
kinds and hop bounds) run their rows together through one
:class:`SharedProgram`, whose labels, keys and predicates are per-row
operand stacks.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.executor import (
    ExecConfig, ExecEngine, Metrics, ReachResult, _active_rows_per_source,
    _hop_cost_per_source, _hop_cost_rows, _hop_dense, _hop_kernel,
    _hop_segment, _hop_segment_rows, _init_frontier,
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


# the reference pads each compact edge slice to a multiple of this many
# edges; structural-sharing buckets are cut in these units
SLICE_QUANTUM = 512


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


def block_sizes(rows: int, blk: int, adaptive: bool = False) -> List[int]:
    """Frontier-block launch plan for ``rows`` packed source rows.

    Fixed mode (the per-query read path) pads to whole ``blk`` blocks, at
    least one.  Adaptive mode (the serve path) sizes a batch smaller than
    one block to the next power of two >= rows (min 8, capped at ``blk``),
    so a point-client group of 8 rows launches an 8-row block instead of
    padding to 256; larger batches keep full ``blk`` blocks.
    """
    if not adaptive or rows >= blk:
        r_pad = max(round_up(max(rows, 1), blk), blk)
        return [blk] * (r_pad // blk)
    b = 8
    while b < rows:
        b *= 2
    return [min(b, blk)]


@dataclass
class RowResult:
    """Per-source-row outputs of one executed binding: the dense reach rows
    plus the per-row DBHit/Rows vectors, so the rows of each query packed
    into one batch are attributed exactly, and any subset of rows can be
    re-attributed without re-executing (the serve engine memoizes these and
    answers subsumed point bindings by gathering rows)."""

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

    def covers(self, sources: np.ndarray) -> bool:
        """Is every id of ``sources`` a row of this result?  Requires
        ``self.sources`` sorted ascending (true of ``default_sources``
        bindings, the only ones the serve engine gathers from)."""
        own = self.sources
        if own.shape[0] == 0:
            return int(np.asarray(sources).shape[0]) == 0
        idx = np.searchsorted(own, sources)
        idx = np.clip(idx, 0, own.shape[0] - 1)
        return bool(np.all(own[idx] == sources))

    def gather(self, sources: np.ndarray) -> "RowResult":
        """Exact row-subset view for ``sources`` ⊆ ``self.sources`` (sorted
        ascending); duplicate ids map to the same row, like re-execution."""
        sources = np.asarray(sources, np.int32)
        idx = np.searchsorted(self.sources, sources)
        return RowResult(sources, self.reach[idx], self.db_vec[idx],
                         self.rows_vec[idx], self.counting)


def _expand_range(F, db, rows, lo: int, hi: int, hop, cost, counting: bool,
                  collect: bool, max_iters: int):
    """One expand step's hop range ``[lo, hi]`` over frontier ``F``.

    ``hop(F, db, rows, skip_db=False) -> (F', db, rows)`` is one hop;
    ``cost(reach)`` the step's per-row DBHit over a reach set.  Bounded:
    ``acc = Σ/∨ over k in [lo, hi]``; hops past an empty frontier add zero
    to F and both metrics, so no early break is needed for exactness.
    Unbounded: a host loop with the reference's ``max_closure_iters`` bound
    and convergence flag.  Successive closure frontiers are pairwise
    disjoint with union equal to the converged reach set, so the closure's
    DBHit telescopes to one ``cost(reach)``; a non-converged exit
    over-counts the residual frontier, but the caller raises before it
    surfaces.  Returns ``(F, db, rows, converged)``."""
    if hi != INF_HOPS:
        acc = F if lo == 0 else None
        cur = F
        for k in range(1, hi + 1):
            cur, db, rows = hop(cur, db, rows)
            if k >= lo:
                acc = cur if acc is None else (
                    acc + cur if counting else acc | cur)
        F = acc if acc is not None else torch.zeros_like(F)
        return F, db, rows, True
    cur = F
    for _ in range(max(lo, 0)):
        cur, db, rows = hop(cur, db, rows)
    reach, frontier = cur, cur
    i = 0
    while i < max_iters and bool(frontier.any()):
        nxt, db, rows = hop(frontier, db, rows, skip_db=True)
        reach, frontier = reach | nxt, nxt & ~reach
        i += 1
    if collect:
        db = db + cost(reach)
    return reach, db, rows, not bool(frontier.any())


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
        # (node label id, prop) pairs the filters read: the serve engine's
        # fence/conflict scoping unit (NO_LABEL = any label)
        self._nprop_pairs: FrozenSet[Tuple[int, str]] = frozenset(
            (s.label_id, p.prop)
            for s in self.steps if isinstance(s, FilterStep)
            for p in s.preds)
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

        def hop(Fc, db, rows, step_ops, backend, reverses, skip_db=False):
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
            F, db, rows, converged = _expand_range(
                F, db, rows, step.min_hops, step.max_hops,
                functools.partial(hop, step_ops=step_ops,
                                  backend=step.backend,
                                  reverses=step.reverses),
                lambda R, step_ops=step_ops: sum(
                    _hop_cost_per_source(R, arrs[-1]) for arrs in step_ops),
                counting, collect, self.cfg.max_closure_iters)
            ok = ok and converged
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

    def execute_rows(self, source_lists: Sequence[np.ndarray], *,
                     adaptive_blocks: bool = False) -> List[RowResult]:
        """:meth:`execute_batch` without the per-query metric folding:
        :class:`RowResult` s carry the raw per-row DBHit/Rows vectors.
        ``adaptive_blocks`` enables the serve path's power-of-two block
        sizing (see :func:`block_sizes`)."""
        g = self.engine.g
        counts = [int(np.asarray(s).shape[0]) for s in source_lists]
        R = sum(counts)
        sizes = block_sizes(R, self.cfg.src_block, adaptive_blocks)
        padded = np.full(sum(sizes), -1, np.int32)
        if R:
            padded[:R] = np.concatenate(
                [np.asarray(s, np.int32) for s in source_lists])
        nprops = tuple(g.node_prop_col(name) for name in self._nprop_names)
        operands = self._gather_operands()

        reach, db_vec, rows_vec = _run_blocks(
            lambda ids: self._program(ids, g.node_label, g.node_key,
                                      g.node_alive, nprops, operands),
            sizes, (padded,), g.device, R)
        results: List[RowResult] = []
        off = 0
        for srcs, S in zip(source_lists, counts):
            results.append(RowResult(
                sources=np.asarray(srcs, np.int32),
                reach=reach[off:off + S], db_vec=db_vec[off:off + S],
                rows_vec=rows_vec[off:off + S], counting=self.counting))
            off += S
        return results


    # -- structural sharing ------------------------------------------------

    def structure_key(self) -> Optional[tuple]:
        """Structure-only fingerprint: the program's shape with labels, keys
        and predicates demoted to per-row operands.  Plans with equal keys
        can execute through one :class:`SharedProgram`.  Only all-segment
        plans are eligible (dense hops would stack ``[M, N, N]``
        adjacencies); direction is folded into the operands, so an IN hop
        and an OUT hop share structure.  ``None`` when ineligible."""
        sig: List[tuple] = []
        for s in self.steps:
            if isinstance(s, FilterStep):
                sig.append(("f",))
            else:
                if s.backend != "segment":
                    return None
                sig.append(("x", len(s.reverses), s.min_hops, s.max_hops))
        if not any(t[0] == "x" for t in sig):
            return None
        return (self.counting, self.cfg.collect_metrics,
                self.cfg.max_closure_iters, tuple(sig))

    def share_scales(self) -> Tuple[int, ...]:
        """log2-quantized edge-slice sizes per expand step.  Shared buckets
        partition on these, so padding members to a common edge count never
        inflates a member's per-row hop work by more than 2x.  Sizes count
        in the reference's slice quantum (its slices are padded to whole
        ``SLICE_QUANTUM`` edges), so buckets match the reference's."""
        out = []
        for s in self.steps:
            if isinstance(s, ExpandStep):
                esrc, _, _, _ = self.engine.label_edges(s.label_id, s.preds)
                n = max(round_up(int(esrc.shape[0]), SLICE_QUANTUM),
                        SLICE_QUANTUM)
                out.append((n - 1).bit_length())
        return tuple(out)

    def _gather_shared_operands(self):
        """Operands for a :class:`SharedProgram` member: per-filter node
        masks (label/key/alive/predicates folded into one ``[N]`` bool, the
        mask :meth:`_program` computes) and per-expand per-direction edge
        tuples with reverse pre-applied.  Fetched fresh per execution."""
        eng = self.engine
        g = eng.g
        masks, expands = [], []
        for step in self.steps:
            if isinstance(step, FilterStep):
                m = g.node_mask(step.label_id, step.key)
                if step.preds:
                    m = m & node_pred_mask(g, step.preds)
                masks.append(m)
            else:
                per_dir = []
                for rev in step.reverses:
                    esrc, edst, ew, emask = eng.label_edges(step.label_id,
                                                            step.preds)
                    deg = eng.deg(step.label_id, rev, step.preds)
                    a, b = (edst, esrc) if rev else (esrc, edst)
                    per_dir.append((a, b, ew, emask, deg))
                expands.append(tuple(per_dir))
        return tuple(masks), tuple(expands)


def _run_blocks(fn, sizes: Sequence[int], row_ops: Sequence[np.ndarray],
                device, R: int):
    """Run ``fn`` over consecutive ``sizes`` blocks of the padded per-row
    arrays ``row_ops`` and bring back (reach [R, N] int32, db_vec, rows_vec);
    raises if a closure did not converge."""
    out_rows, db_parts, row_parts = [], [], []
    converged = True
    b0 = 0
    for blk in sizes:
        F, db, rows, ok = fn(*(torch.from_numpy(a[b0:b0 + blk]).to(device)
                               for a in row_ops))
        out_rows.append(host(F))
        db_parts.append(host(db))
        row_parts.append(host(rows))
        converged = converged and ok
        b0 += blk
    if not converged:
        raise RuntimeError("closure did not converge within max_closure_iters")
    reach = np.concatenate(out_rows, axis=0)[:R].astype(np.int32)
    return reach, np.concatenate(db_parts)[:R], np.concatenate(row_parts)[:R]


# ---------------------------------------------------------------------------
# shared structural program
# ---------------------------------------------------------------------------

class SharedProgram:
    """One fused program serving a plan-*structure* equivalence class.

    Where :class:`CompiledPlan` bakes labels/keys/predicates in as
    constants, a shared program takes them as *stacked operands*: per-filter
    node masks ``[M, N]`` and per-hop edge slices ``[M, E]`` for the ``M``
    member plans of a window bucket, with every frontier row carrying a
    member index that selects its row of each stack.  Queries that differ
    only in labels, predicates and sources run as one batch.

    Exactness: the row hops (:func:`_hop_segment_rows`,
    :func:`_hop_cost_rows`) are the homogeneous hops with the operand
    broadcast made explicit, so a row computes bit for bit what its plan's
    own program computes, per-row DBHit/Rows included.  Members pad to a
    power-of-two count with member 0's operands, edge stacks to the
    bucket's power-of-two maximum with masked-off edges, and padded rows
    carry id -1: each contributes exactly zero.
    """

    def __init__(self, counting: bool, collect_metrics: bool,
                 max_closure_iters: int, steps_sig: Tuple[tuple, ...]):
        self.counting = counting
        self.collect = collect_metrics
        self.max_closure_iters = max_closure_iters
        self.steps_sig = steps_sig

    def _program(self, ids, midx, masks, operands):
        """One source block: ``ids`` [blk] (-1 padding), ``midx`` [blk]
        member indices, ``masks`` one [M, N] bool stack per filter step,
        ``operands`` one per-direction (src, dst, ew, emask, deg) stack
        tuple per expand step.  Mirrors :meth:`CompiledPlan._program` with
        member-selected operands."""
        counting, collect = self.counting, self.collect
        blk = ids.shape[0]
        N = masks[0].shape[1] if masks else operands[0][0][4].shape[1]
        F = _init_frontier(ids, N, counting)
        db = torch.zeros(blk, dtype=torch.int64, device=ids.device)
        rows = torch.zeros(blk, dtype=torch.int64, device=ids.device)
        ok = True

        def hop(Fc, db, rows, step_rows, skip_db=False):
            out = None
            for (a, b, ew, emask, deg) in step_rows:
                if collect and not skip_db:
                    db = db + _hop_cost_rows(Fc, deg)
                nxt = _hop_segment_rows(Fc, a, b, emask, ew,
                                        counting=counting)
                out = nxt if out is None else (
                    out + nxt if counting else out | nxt)
            if collect:
                rows = rows + _active_rows_per_source(out)
            return out, db, rows

        mi = oi = 0
        for sig in self.steps_sig:
            if sig[0] == "f":
                m = masks[mi][midx]           # [blk, N] per-row node mask
                mi += 1
                F = torch.where(m, F, 0) if counting else F & m
                continue
            _, ndirs, lo, hi = sig
            # member-select each direction's operands once per step; every
            # hop of the step reuses the gathered rows
            step_rows = tuple(tuple(arr[midx] for arr in operands[oi][d])
                              for d in range(ndirs))
            oi += 1
            F, db, rows, converged = _expand_range(
                F, db, rows, lo, hi,
                functools.partial(hop, step_rows=step_rows),
                lambda R, step_rows=step_rows: sum(
                    _hop_cost_rows(R, arrs[4]) for arrs in step_rows),
                counting, collect, self.max_closure_iters)
            ok = ok and converged
        return F, db, rows, ok

    def execute(self, plans: Sequence[CompiledPlan],
                spec_lists: Sequence[Sequence[np.ndarray]], *,
                adaptive_blocks: bool = True) -> List[List[RowResult]]:
        """Run several same-structure plans' bindings as one padded batch.

        ``spec_lists[m]`` holds plan ``m``'s unique source bindings; all
        rows of all members pack back-to-back into shared blocks, each row
        tagged with its member index.  Returns per-plan lists of
        :class:`RowResult` matching ``spec_lists``."""
        cfg = plans[0].cfg
        dev = plans[0].engine.device
        M = len(plans)
        M_pad = 1 << max(M - 1, 1).bit_length()    # pow2 >= M, min 2
        gathered = [p._gather_shared_operands() for p in plans]

        n_filters = sum(1 for s in self.steps_sig if s[0] == "f")
        masks_st = []
        for fi in range(n_filters):
            ms = [gathered[m][0][fi] for m in range(M)]
            masks_st.append(torch.stack(ms + [ms[0]] * (M_pad - M)))

        ops_st = []
        n_expands = sum(1 for s in self.steps_sig if s[0] == "x")
        for oi in range(n_expands):
            per_dir = []
            for d in range(len(gathered[0][1][oi])):
                cols = [gathered[m][1][oi][d] for m in range(M)]
                # edge widths pad to the pow2 ceiling of the bucket max, so
                # recurring shapes recur across windows; members share a
                # log2 scale, so padding stays within the bucket's 2x bound
                # (padded edges are masked off: exact no-ops)
                E_max = max(int(c[0].shape[0]) for c in cols)
                E = 1 << max(E_max - 1, 1).bit_length()
                stacked = []
                for j in range(5):          # src, dst, ew, emask, deg
                    arrs = [c[j] if j == 4 else torch.nn.functional.pad(
                        c[j], (0, E - int(c[j].shape[0]))) for c in cols]
                    stacked.append(torch.stack(arrs + [arrs[0]] * (M_pad - M)))
                per_dir.append(tuple(stacked))
            ops_st.append(tuple(per_dir))
        masks_st, ops_st = tuple(masks_st), tuple(ops_st)

        layout: List[Tuple[int, int, int]] = []   # (member, offset, S)
        src_parts, midx_parts = [], []
        off = 0
        for m, specs in enumerate(spec_lists):
            for s in specs:
                arr = np.asarray(s, np.int32)
                S = int(arr.shape[0])
                layout.append((m, off, S))
                src_parts.append(arr)
                midx_parts.append(np.full(S, m, np.int64))
                off += S
        R = off
        sizes = block_sizes(R, cfg.src_block, adaptive_blocks)
        ids = np.full(sum(sizes), -1, np.int32)
        midx = np.zeros(sum(sizes), np.int64)
        if R:
            ids[:R] = np.concatenate(src_parts)
            midx[:R] = np.concatenate(midx_parts)
        reach, db_vec, rows_vec = _run_blocks(
            lambda i, mi: self._program(i, mi, masks_st, ops_st),
            sizes, (ids, midx), dev, R)
        results: List[List[RowResult]] = [[] for _ in plans]
        for src, (m, off, S) in zip(src_parts, layout):
            results[m].append(RowResult(
                sources=src, reach=reach[off:off + S],
                db_vec=db_vec[off:off + S], rows_vec=rows_vec[off:off + S],
                counting=self.counting))
        return results


# ---------------------------------------------------------------------------
# planner: the session plan cache
# ---------------------------------------------------------------------------

class QueryPlanner:
    """Session-lifetime owner of the rewrite cache and the plan cache.

    ``plan(q, views, view_gen)`` is the whole compile pipeline; both caches
    key off the query fingerprint.  ``plan_hits`` / ``plan_misses`` and
    ``rewrite_hits`` / ``rewrite_misses`` make the caching observable;
    ``rewrite_seconds_total`` over ``plan_calls`` is the amortized rewrite
    cost.
    """

    def __init__(self, engine: ExecEngine, schema: GraphSchema,
                 cfg: Optional[ExecConfig] = None):
        self.engine = engine
        self.schema = schema
        self.cfg = cfg or engine.cfg
        self._plans: Dict[Tuple[QueryFingerprint, bool], CompiledPlan] = {}
        self._rewrites: Dict[Tuple[QueryFingerprint, int],
                             Tuple[PathPattern, bool]] = {}
        self._shared: Dict[tuple, SharedProgram] = {}
        self.plan_hits = 0
        self.plan_misses = 0
        self.rewrite_hits = 0
        self.rewrite_misses = 0
        self.plan_calls = 0
        self.rewrite_seconds_total = 0.0

    def plan(self, q: Query, views: Sequence, view_gen: int
             ) -> Tuple[CompiledPlan, float]:
        """Fingerprint → (memoized) rewrite → (cached) physical plan.
        Returns ``(plan, rewrite_seconds spent on this call)``."""
        self.plan_calls += 1
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
                self.rewrite_seconds_total += rewrite_s
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

    def shared_program(self, key: tuple) -> SharedProgram:
        """The session-lifetime :class:`SharedProgram` for a structure key
        (:meth:`CompiledPlan.structure_key`).  Labels and predicates are
        operands, so label epochs never stale it."""
        sp = self._shared.get(key)
        if sp is None:
            sp = self._shared[key] = SharedProgram(*key)
        return sp

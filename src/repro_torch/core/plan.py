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
   block, with DBHit/Rows accumulated as per-row device vectors.  Every
   block's reach rows and metric vectors stay on the device until the last
   block has run; then one :func:`~repro_torch.utils.host` call pulls them
   all (one pull per batch, as the reference).

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
``max_closure_iters`` bound; it reads its "frontier is empty" flag
(:func:`~repro_torch.utils.host_flag`) after its first iteration, then
every ``CLOSURE_SYNC_EVERY``: hops past an empty frontier add exactly zero,
so the stride never changes an answer.  Its DBHit telescopes to one multiply-sum over the converged reach
set.

**Sharded execution** (``ExecConfig(data_shards=N)``, DESIGN.md §12).  One
controller drives N shards, shard ``s``'s tensors on the engine's
``shard_devices()[s]``: node columns split into N equal ranges, each
label's edges go to the shard that owns their scatter-side endpoint, and a
hop all-gathers the frontier's columns (one concatenation per distinct
device, shared by the shards on it), gathers from the full frontier and
scatters into the shard's own columns.  DBHit and Rows accumulate as
per-shard partials and are summed once at the end of the program (the
psum); a closure's convergence flag is the sum over shards.  Every hop of a
sharded plan is a segment hop.

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
    _hop_segment, _hop_segment_local, _hop_segment_rows,
    _hop_segment_rows_local, _init_frontier,
)
from repro_torch.core.graph import node_pred_mask
from repro_torch.core.parser import query_fingerprint
from repro_torch.core.pattern import (
    Direction, PathPattern, PropPred, Query, QueryFingerprint, _cmp,
    normalize_preds,
)
from repro_torch.core.schema import GraphSchema, NO_LABEL
from repro_torch.utils import INF_HOPS, host, host_flag, round_up, trace
from repro_torch.utils.device import pinned_empty


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
    if cfg.data_shards > 1:
        # shards hold partitioned edge slices; a dense hop would need the
        # whole [N, N] adjacency on every shard (DESIGN.md §12)
        return "segment"
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
            cfg.dense_node_limit, cfg.dense_density, cfg.data_shards)


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
    reach: np.ndarray      # [S, N] int32 walk counts; bool under set semantics
    db_vec: np.ndarray     # [S] int64 per-row DBHit contributions
    rows_vec: np.ndarray   # [S] int64 per-row Rows contributions
    counting: bool

    def to_reach_result(self) -> ReachResult:
        """The :class:`ReachResult` a solo ``execute`` returns: S + the
        row-vector sums."""
        S = int(self.sources.shape[0])
        return ReachResult(
            src_ids=self.sources, reach=self.reach, counting=self.counting,
            metrics=Metrics(db_hits=S + int(np.sum(self.db_vec)),
                            rows=S + int(np.sum(self.rows_vec))))

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


# a closure reads its convergence flag after its first iteration, then
# every CLOSURE_SYNC_EVERY iterations.  On the card a flag read costs about
# a fifth of one more (empty) hop at SNB's shape, so the stride stays short
# (PERF.md §5 has the numbers behind it)
CLOSURE_SYNC_EVERY = 2


class ShardCols(tuple):
    """One logical tensor held as per-shard parts, shard ``s``'s on its own
    device: a frontier's ``[blk, n_loc]`` column blocks, or a per-shard
    partial metric vector.  Elementwise operators apply part by part, so
    the hop-range algebra of :func:`_expand_range` runs unchanged."""

    def _zip(self, other, op):
        return ShardCols(op(x, y) for x, y in zip(self, other))

    def __add__(self, other):
        return self._zip(other, lambda x, y: x + y)

    def __or__(self, other):
        return self._zip(other, lambda x, y: x | y)

    def __and__(self, other):
        return self._zip(other, lambda x, y: x & y)

    def __invert__(self):
        return ShardCols(~x for x in self)


def _zeros_like(F):
    if isinstance(F, ShardCols):
        return ShardCols(torch.zeros_like(x) for x in F)
    return torch.zeros_like(F)


def _any_active(F) -> torch.Tensor:
    """Device bool: does any row of ``F`` hold a set column?  Over shards,
    the sum of the shards' flags (on the first shard's device)."""
    if isinstance(F, ShardCols):
        dev = F[0].device
        return torch.stack([x.any().to(dev) for x in F]).any()
    return F.any()


def _all_gather(parts: Sequence[torch.Tensor], devs: Sequence) -> Dict:
    """The frontier's full ``[blk, N_pad]`` columns on every distinct device
    of ``devs``: one copy of each shard's columns there and one
    concatenation, shared by all the shards on that device."""
    return {d: torch.cat([x.to(d) for x in parts], dim=1)
            for d in dict.fromkeys(devs)}


def _shard_init(ids: torch.Tensor, devs: Sequence, n_loc: int,
                counting: bool):
    """A sharded program's start: the padded id block on every shard
    device, each shard's local one-hot frontier columns (a source lands on
    the shard that owns it), and zero per-shard DBHit/Rows partials."""
    on = {d: ids.to(d) for d in dict.fromkeys(devs)}
    blk = ids.shape[0]
    F = []
    for s, d in enumerate(devs):
        lcol = on[d] - s * n_loc
        mine = (on[d] >= 0) & (lcol >= 0) & (lcol < n_loc)
        f = torch.zeros((blk, n_loc), device=d,
                        dtype=torch.int32 if counting else torch.bool)
        f[torch.arange(blk, device=d), lcol.clamp(0, n_loc - 1).long()] = \
            mine.to(f.dtype)
        F.append(f)
    zeros = ShardCols(torch.zeros(blk, dtype=torch.int64, device=d)
                      for d in devs)
    return on, ShardCols(F), zeros, zeros


def _shard_hop(Fc, db, rows, step_ops, devs, n_loc: int, counting: bool,
               collect: bool, seg, cost_fn, skip_db: bool = False):
    """One sharded expansion hop: the frontier's columns all-gathered once
    (the only per-hop exchange), then per direction and shard the DBHit
    partial (``cost_fn`` of the full frontier and the shard's partial
    degrees) and ``seg``, which gathers from the full frontier and
    scatters into the shard's own columns.  ``step_ops`` holds one
    ``(a, b_local, w, mask, deg)`` tuple of per-shard tuples a direction."""
    full = _all_gather(Fc, devs)
    out = None
    for arrs in step_ops:
        if collect and not skip_db:
            db = db + ShardCols(cost_fn(full[d], arrs[4][s])
                                for s, d in enumerate(devs))
        a, b_local, w, mask = arrs[:4]
        nxt = ShardCols(seg(full[d], a[s], b_local[s], mask[s], w[s],
                            counting=counting, n_loc=n_loc)
                        for s, d in enumerate(devs))
        out = nxt if out is None else (out + nxt if counting else out | nxt)
    if collect:
        rows = rows + ShardCols(_active_rows_per_source(x) for x in out)
    return out, db, rows


def _shard_cost(R, step_ops, devs, cost_fn):
    """A closure's telescoped DBHit over reach set ``R``, as per-shard
    partials: the full columns read against each shard's partial
    degrees."""
    full = _all_gather(R, devs)
    out = None
    for arrs in step_ops:
        c = ShardCols(cost_fn(full[d], arrs[4][s])
                      for s, d in enumerate(devs))
        out = c if out is None else out + c
    return out


def _shard_result(F, db, rows, ok: bool, devs):
    """F reassembled ``[blk, N_pad]`` on the first shard's device, and the
    per-shard metric partials summed there (the program's one psum)."""
    d0 = devs[0]
    return (torch.cat([f.to(d0) for f in F], dim=1),
            sum(x.to(d0) for x in db), sum(x.to(d0) for x in rows), ok)


def _expand_range(F, db, rows, lo: int, hi: int, hop, cost, counting: bool,
                  collect: bool, max_iters: int):
    """One expand step's hop range ``[lo, hi]`` over frontier ``F`` (a
    tensor, or :class:`ShardCols` under sharding).

    ``hop(F, db, rows, skip_db=False) -> (F', db, rows)`` is one hop;
    ``cost(reach)`` the step's per-row DBHit over a reach set.  Bounded:
    ``acc = Σ/∨ over k in [lo, hi]``; hops past an empty frontier add zero
    to F and both metrics, so no early break is needed for exactness.
    Unbounded: a host loop with the reference's ``max_closure_iters`` bound
    that reads the "frontier is empty" flag after its first iteration and
    then every ``CLOSURE_SYNC_EVERY``, and never hops past the bound; hops
    after the frontier empties add zero to reach and Rows (and skip DBHit),
    so the answer is the reference's.  Successive closure
    frontiers are pairwise disjoint with union equal to the converged reach
    set, so the closure's DBHit telescopes to one ``cost(reach)``; a
    non-converged exit over-counts the residual frontier, but the caller
    raises before it surfaces.  Traced, the unbounded loop is the span
    ``exec.closure``: ``iters`` the hops it ran, its flag reads its
    ``pulls``.  Returns ``(F, db, rows, converged)``."""
    if hi != INF_HOPS:
        acc = F if lo == 0 else None
        cur = F
        for k in range(1, hi + 1):
            cur, db, rows = hop(cur, db, rows)
            if k >= lo:
                acc = cur if acc is None else (
                    acc + cur if counting else acc | cur)
        F = acc if acc is not None else _zeros_like(F)
        return F, db, rows, True
    cur = F
    for _ in range(max(lo, 0)):
        cur, db, rows = hop(cur, db, rows)
    reach, frontier = cur, cur
    i, stride = 0, 1
    with trace.span("exec.closure", iters=0):
        converged = max_iters > 0 or not host_flag(_any_active(frontier))
        while i < max_iters:
            n = min(stride, max_iters - i)
            for _ in range(n):
                nxt, db, rows = hop(frontier, db, rows, skip_db=True)
                reach, frontier = reach | nxt, nxt & ~reach
            i += n
            trace.add("iters", n)
            converged = not host_flag(_any_active(frontier))
            if converged:
                break
            stride = CLOSURE_SYNC_EVERY
    if collect:
        db = db + cost(reach)
    return reach, db, rows, converged


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

    def _filter(self, F, step: FilterStep, node_label, node_key,
                node_alive, nprops):
        """F masked to the columns whose nodes pass ``step`` (node arrays
        and ``nprops`` cover F's columns: the whole arena, or a shard's)."""
        m = node_alive
        if step.label_id != NO_LABEL:
            m = m & (node_label == step.label_id)
        if step.key is not None:
            m = m & (node_key == step.key)
        for p in step.preds:
            m = m & _cmp(nprops[self._nprop_names.index(p.prop)],
                         p.op, p.value)
        return (torch.where(m[None, :], F, 0) if self.counting
                else F & m[None, :])

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
                F = self._filter(F, step, node_label, node_key, node_alive,
                                 nprops)
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

    def _program_sharded(self, ids, node_label, node_key, node_alive,
                         nprops, operands):
        """:meth:`_program` over the engine's shards, in one controller.

        Node arrays arrive as per-shard ``[n_loc]`` column tuples, each
        edge operand as the per-shard tuple of the shard's partition, and F
        is a :class:`ShardCols` of ``[blk, n_loc]`` blocks (hops:
        :func:`_shard_hop`).  DBHit/Rows accumulate as per-shard partials
        (partial degree vectors, local-column row counts) and are summed
        once at the end, so they equal :meth:`_program`'s exactly.
        Returns F reassembled ``[blk, N_pad]`` on the first shard's device,
        with the summed metric vectors."""
        counting = self.counting
        collect = self.cfg.collect_metrics
        devs = self.engine.shard_devices()
        n_loc = node_label[0].shape[0]
        _, F, db, rows = _shard_init(ids, devs, n_loc, counting)
        ok = True
        op_i = 0
        for step in self.steps:
            if isinstance(step, FilterStep):
                F = ShardCols(self._filter(
                    f, step, node_label[s], node_key[s], node_alive[s],
                    tuple(c[s] for c in nprops)) for s, f in enumerate(F))
                continue
            step_ops = operands[op_i]
            op_i += 1
            F, db, rows, converged = _expand_range(
                F, db, rows, step.min_hops, step.max_hops,
                functools.partial(
                    _shard_hop, step_ops=step_ops, devs=devs, n_loc=n_loc,
                    counting=counting, collect=collect,
                    seg=_hop_segment_local, cost_fn=_hop_cost_per_source),
                functools.partial(_shard_cost, step_ops=step_ops, devs=devs,
                                  cost_fn=_hop_cost_per_source),
                counting, collect, self.cfg.max_closure_iters)
            ok = ok and converged
        return _shard_result(F, db, rows, ok, devs)

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

    def _gather_operands_sharded(self):
        """Sharded counterpart of :meth:`_gather_operands`: per expand step,
        per direction, the engine's cached dst-partitioned operands, shard
        by shard on the shards' devices."""
        eng = self.engine
        return tuple(
            tuple(eng.sharded_label_edges(step.label_id, rev, step.preds)
                  for rev in step.reverses)
            for step in self.steps if isinstance(step, ExpandStep))

    # -- execution ---------------------------------------------------------

    def default_sources(self) -> np.ndarray:
        """Source node ids selected by the plan's start constraints on the
        *current* graph."""
        with trace.span("exec.prepare"):
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
        rows = self.execute_rows(source_lists)
        with trace.span("exec.result"):
            return [rr.to_reach_result() for rr in rows]

    def execute_rows(self, source_lists: Sequence[np.ndarray], *,
                     adaptive_blocks: bool = False) -> List[RowResult]:
        """:meth:`execute_batch` without the per-query metric folding:
        :class:`RowResult` s carry the raw per-row DBHit/Rows vectors.
        ``adaptive_blocks`` enables the serve path's power-of-two block
        sizing (see :func:`block_sizes`)."""
        with trace.span("exec.prepare"):
            g = self.engine.g
            counts = [int(np.asarray(s).shape[0]) for s in source_lists]
            R = sum(counts)
            sizes = block_sizes(R, self.cfg.src_block, adaptive_blocks)
            padded = np.full(sum(sizes), -1, np.int32)
            if R:
                padded[:R] = np.concatenate(
                    [np.asarray(s, np.int32) for s in source_lists])
            if self.cfg.data_shards > 1:
                eng = self.engine
                node_label, node_key, node_alive, nprops = \
                    eng.sharded_node_data(self._nprop_names)
                operands = self._gather_operands_sharded()
                program, dev = self._program_sharded, eng.shard_devices()[0]
            else:
                node_label, node_key, node_alive = (g.node_label, g.node_key,
                                                    g.node_alive)
                nprops = tuple(g.node_prop_col(name)
                               for name in self._nprop_names)
                operands = self._gather_operands()
                program, dev = self._program, g.device
        reach, db_vec, rows_vec = _run_blocks(
            lambda ids: program(ids, node_label, node_key, node_alive,
                                nprops, operands),
            sizes, (padded,), dev, R, g.node_cap, self.counting)
        with trace.span("exec.result"):
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

    def _gather_shared_operands_sharded(self):
        """Sharded counterpart of :meth:`_gather_shared_operands`: node
        masks padded to ``[N_pad]`` and the dst-partitioned per-shard edge
        tuples per expand direction; the sharded :class:`SharedProgram`
        stacks members shard by shard."""
        eng = self.engine
        g = eng.g
        masks, expands = [], []
        for step in self.steps:
            if isinstance(step, FilterStep):
                m = g.node_mask(step.label_id, step.key)
                if step.preds:
                    m = m & node_pred_mask(g, step.preds)
                masks.append(eng.padded_node_mask(m))
            else:
                expands.append(tuple(
                    eng.sharded_label_edges(step.label_id, rev, step.preds)
                    for rev in step.reverses))
        return tuple(masks), tuple(expands)


def _run_blocks(fn, sizes: Sequence[int], row_ops: Sequence[np.ndarray],
                device, R: int, width: int, counting: bool):
    """Run ``fn`` over consecutive ``sizes`` blocks of the padded per-row
    arrays ``row_ops`` and bring back (reach [R, width], db_vec, rows_vec):
    int32 walk counts when ``counting``, or bool reachability under set
    semantics; raises if a closure did not converge.

    The per-row arrays go to the device once.  Each block writes its F into
    one ``[R_pad, width]`` device tensor of the rows' type (sliced to
    ``width``: sharded F carries pad columns; a set-semantics F is bool on
    every route and is copied as it is, one byte an entry) and its metric
    vectors into ``[R_pad]`` int64 device vectors (no concatenation, so no
    second copy); after the last block one :func:`host` call pulls the rows
    and the metrics — one pull per batch, whatever the block count.

    On a CUDA device the rows land in a page-locked ``[R, width]`` tensor
    of the same type from the caching pinned-host allocator
    (:func:`pinned_empty`), taken before the wait below so that it overlaps
    the hops: one DMA, and its memory is the result.  A kept result keeps
    its block, so no later batch writes into it.  On the CPU the result is
    the device tensor's own memory, fresh for each call.

    Traced, the pull is the span ``exec.pull``, entered once the device has
    run the blocks (:func:`trace.settle`), so that it times the copies
    alone; it counts the ``rows`` it pulled and ``byte_rows``, those pulled
    at one byte an entry (all of a set-semantics batch's, none of a
    counting one's), on every device, and the ``bytes`` copied off a CUDA
    device and ``pinned_new``, the blocks the pinned pool had to create for
    them."""
    ops_dev = [torch.from_numpy(a).to(device) for a in row_ops]
    R_pad = sum(sizes)
    dtype = torch.int32 if counting else torch.bool
    reach_all = torch.empty((R_pad, width), dtype=dtype, device=device)
    db_all = torch.zeros(R_pad, dtype=torch.int64, device=device)
    rows_all = torch.zeros(R_pad, dtype=torch.int64, device=device)
    converged = True
    b0 = 0
    for blk in sizes:
        F, db, rows, ok = fn(*(a[b0:b0 + blk] for a in ops_dev))
        reach_all[b0:b0 + blk] = F[:, :width]
        db_all[b0:b0 + blk] = db
        rows_all[b0:b0 + blk] = rows
        converged = converged and ok
        b0 += blk
    if not converged:
        raise RuntimeError("closure did not converge within max_closure_iters")
    met = torch.stack([db_all[:R], rows_all[:R]])
    dst = new = None
    if reach_all.is_cuda:
        dst, new = pinned_empty((R, width), dtype)
    trace.settle(device)
    with trace.span("exec.pull"):
        reach, met = host(reach_all[:R], met, out=dst)
        trace.add("rows", R)
        trace.add("byte_rows", 0 if counting else R)
        if dst is not None:
            trace.add("bytes", reach.nbytes + met.nbytes)
            trace.add("pinned_new", new)
    return reach, met[0], met[1]


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
                 max_closure_iters: int, steps_sig: Tuple[tuple, ...],
                 engine: Optional[ExecEngine] = None, data_shards: int = 1):
        self.counting = counting
        self.collect = collect_metrics
        self.max_closure_iters = max_closure_iters
        self.steps_sig = steps_sig
        self.engine = engine
        self.data_shards = data_shards

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

    def _program_sharded(self, ids, midx, masks, operands):
        """:meth:`_program` over the engine's shards: ``masks`` arrive as
        per-shard ``[M, n_loc]`` column tuples, each edge stack as the
        per-shard tuple of ``[M, Ep]`` partitions (deg ``[M, N_pad]``), and
        rows scatter into their shard's columns only.  Metric partials and
        closure convergence follow :meth:`CompiledPlan._program_sharded`."""
        counting, collect = self.counting, self.collect
        devs = self.engine.shard_devices()
        n_loc = (masks[0][0].shape[1] if masks
                 else operands[0][0][4][0].shape[1] // len(devs))
        on, F, db, rows = _shard_init(ids, devs, n_loc, counting)
        midx_on = {d: midx.to(d) for d in on}
        ok = True
        mi = oi = 0
        for sig in self.steps_sig:
            if sig[0] == "f":
                ms = [masks[mi][s][midx_on[d]] for s, d in enumerate(devs)]
                mi += 1
                F = ShardCols(torch.where(m, f, 0) if counting else f & m
                              for f, m in zip(F, ms))
                continue
            _, ndirs, lo, hi = sig
            # member-select each shard's operands once per step
            step_rows = tuple(
                tuple(tuple(arr[s][midx_on[d]] for s, d in enumerate(devs))
                      for arr in operands[oi][di])
                for di in range(ndirs))
            oi += 1
            F, db, rows, converged = _expand_range(
                F, db, rows, lo, hi,
                functools.partial(
                    _shard_hop, step_ops=step_rows, devs=devs, n_loc=n_loc,
                    counting=counting, collect=collect,
                    seg=_hop_segment_rows_local, cost_fn=_hop_cost_rows),
                functools.partial(_shard_cost, step_ops=step_rows, devs=devs,
                                  cost_fn=_hop_cost_rows),
                counting, collect, self.max_closure_iters)
            ok = ok and converged
        return _shard_result(F, db, rows, ok, devs)

    def execute(self, plans: Sequence[CompiledPlan],
                spec_lists: Sequence[Sequence[np.ndarray]], *,
                adaptive_blocks: bool = True) -> List[List[RowResult]]:
        """Run several same-structure plans' bindings as one padded batch.

        ``spec_lists[m]`` holds plan ``m``'s unique source bindings; all
        rows of all members pack back-to-back into shared blocks, each row
        tagged with its member index.  Returns per-plan lists of
        :class:`RowResult` matching ``spec_lists``."""
        cfg = plans[0].cfg
        eng = plans[0].engine
        M = len(plans)
        M_pad = 1 << max(M - 1, 1).bit_length()    # pow2 >= M, min 2
        sharded = self.data_shards > 1
        gathered = [p._gather_shared_operands_sharded() if sharded
                    else p._gather_shared_operands() for p in plans]

        def stack(arrs, E=None):
            """Members (edge operands padded to E) stacked, then padded to
            M_pad members with member 0's operands."""
            if E is not None:
                arrs = [torch.nn.functional.pad(a, (0, E - int(a.shape[0])))
                        for a in arrs]
            return torch.stack(arrs + [arrs[0]] * (M_pad - M))

        n_filters = sum(1 for s in self.steps_sig if s[0] == "f")
        masks_st = []
        for fi in range(n_filters):
            st = stack([gathered[m][0][fi] for m in range(M)])
            masks_st.append(eng.shard_put_mask_stack(st) if sharded else st)

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
                if sharded:   # each operand a per-shard tuple of [Ep] rows
                    E_max = max(int(c[0][0].shape[0]) for c in cols)
                    E = 1 << max(E_max - 1, 1).bit_length()
                    per_dir.append(tuple(
                        tuple(stack([c[j][s] for c in cols],
                                    E if j < 4 else None)
                              for s in range(self.data_shards))
                        for j in range(5)))      # a, b_local, w, mask, deg
                    continue
                E_max = max(int(c[0].shape[0]) for c in cols)
                E = 1 << max(E_max - 1, 1).bit_length()
                per_dir.append(tuple(
                    stack([c[j] for c in cols], E if j < 4 else None)
                    for j in range(5)))          # src, dst, ew, emask, deg
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
        program = self._program_sharded if sharded else self._program
        dev = eng.shard_devices()[0] if sharded else eng.device
        reach, db_vec, rows_vec = _run_blocks(
            lambda i, mi: program(i, mi, masks_st, ops_st),
            sizes, (ids, midx), dev, R, eng.g.node_cap, self.counting)
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
        self._shared: Dict[tuple, SharedProgram] = {}
        self.plan_hits = 0
        self.plan_misses = 0
        self.rewrite_hits = 0
        self.rewrite_misses = 0
        self.plan_calls = 0

    def plan(self, q: Query, views: Sequence, view_gen: int
             ) -> Tuple[CompiledPlan, float]:
        """Fingerprint → (memoized) rewrite → (cached) physical plan.
        Returns ``(plan, rewrite_seconds spent on this call)``."""
        self.plan_calls += 1
        fp = query_fingerprint(q, self.schema)
        use_views = len(views) > 0
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

    def shared_program(self, key: tuple) -> SharedProgram:
        """The session-lifetime :class:`SharedProgram` for a structure key
        (:meth:`CompiledPlan.structure_key`).  Labels and predicates are
        operands, so label epochs never stale it.  Sharded sessions get a
        sharded program, cached apart (keyed on the shard count)."""
        shards = max(self.cfg.data_shards, 1)
        sp = self._shared.get((key, shards))
        if sp is None:
            sp = self._shared[(key, shards)] = SharedProgram(
                *key, engine=self.engine, data_shards=shards)
        return sp

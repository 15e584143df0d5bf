"""Path-pattern executor: blocked multi-source reachability with metrics.

The GDBMS expand operator becomes tensor algebra over a ``[blk, node_cap]``
frontier ``F`` (int32 walk counts, or bool under set semantics):

* ``segment`` backend — one hop scatters frontier mass along the label's
  compact edge slice: ``F' = index_add(F[:, src] * w, dst)``.  The bool hop
  adds 0/1 messages and tests ``> 0``, which is exactly the scatter-max of
  the reference (torch has no bool scatter-max).
* ``dense`` backend — the label-masked adjacency is materialized as a dense
  ``[N, N]`` int32 tile and a hop is ``F @ A``: an fp64 product cast
  through int64, exact and wrapping to int32 as the reference's int32
  product does (CUDA has no integer matmul), or, with ``use_kernel``, the
  hand-written ``block_spmm`` CUDA kernel.

Hop-range algebra (paper §IV: ``e*n..m``):
  counting, finite m:   ``Σ_{k=n..m} F·A^k``            (exact walk counts)
  boolean, any m:       ``F·A^n`` then frontier closure  (reachability)

Metrics follow the paper's Definitions 2-3: ``DBHit`` counts storage touches
(1 per scanned node, 2 per expanded edge: the edge and its endpoint), ``Rows``
counts active bindings passed between operators.  The per-row DBHit vectors
are int64 multiply-sums on the device; totals accumulate in Python ints.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import (
    LabelEpochs, PropertyGraph, edge_pred_mask, gathered_pred_mask,
    node_pred_mask,
)
from repro_torch.core.pattern import (
    Direction, PathPattern, PropPred, Query, RelPat, normalize_preds,
)
from repro_torch.core.schema import GraphSchema, NO_LABEL
from repro_torch.kernels.ref import matmul_f32
from repro_torch.utils import INF_HOPS, host, host_flag, round_up, trace


@dataclass
class ExecConfig:
    backend: str = "segment"        # "segment" | "dense": unfused PathExecutor
    #                                 backend; "dense" also forces dense hops
    #                                 in compiled plans
    src_block: int = 256            # sources per frontier block
    max_closure_iters: int = 256    # safety bound for unbounded fixpoints
    use_kernel: bool = False        # route dense hops through block_spmm
    collect_metrics: bool = True    # DBHit/Rows accounting
    # --- compiled-plan (core/plan.py) knobs ------------------------------
    plan_backend: str = "auto"      # "auto" = per-hop cost-based choice;
    #                                 "segment"/"dense"/"kernel" force one
    dense_node_limit: int = 4096    # never go dense above this node_cap
    dense_density: float = 0.05     # E_label / node_cap^2 threshold for dense
    data_shards: int = 1            # >1: compiled plans run sharded over the
    #                                 engine's shard devices (node columns
    #                                 and per-label edge slices partitioned
    #                                 by scatter-side owner; DESIGN.md §12)


@dataclass
class Metrics:
    db_hits: int = 0
    rows: int = 0

    def __iadd__(self, other: "Metrics") -> "Metrics":
        self.db_hits += other.db_hits
        self.rows += other.rows
        return self

    def __add__(self, other: "Metrics") -> "Metrics":
        return Metrics(self.db_hits + other.db_hits, self.rows + other.rows)


class PairRows(NamedTuple):
    """Typed (src, dst, count) rows of a reachability result."""

    src: np.ndarray     # [P] source node ids
    dst: np.ndarray     # [P] int32 destination node ids
    count: np.ndarray   # [P] path counts (1s under set semantics)

    @property
    def n_pairs(self) -> int:
        return int(self.src.shape[0])


@dataclass
class ReachResult:
    """Reachability of one query: per-source rows over all node columns."""

    src_ids: np.ndarray             # [S] int32 source node ids
    reach: np.ndarray               # [S, N_cap] int32 walk counts, or bool
    #                                 reachability under set semantics
    counting: bool
    metrics: Metrics = field(default_factory=Metrics)

    def pairs(self) -> PairRows:
        """(src, dst, count) for every reachable pair; ``count`` is int32
        either way (1s under set semantics: only the nonzeros are cast)."""
        rows, cols = np.nonzero(self.reach)
        return PairRows(self.src_ids[rows], cols.astype(np.int32),
                        self.reach[rows, cols].astype(np.int32, copy=False))

    def num_results(self) -> int:
        """Bag cardinality (sum of path counts) — what RETURN n,m yields."""
        return int(self.reach.sum())

    def num_pairs(self) -> int:
        return int((self.reach > 0).sum())


# ---------------------------------------------------------------------------
# single-hop steps (shared with the compiled plans)
# ---------------------------------------------------------------------------

def _hop_segment(F, esrc, edst, emask, eweight, *, counting: bool,
                 reverse: bool):
    """One expansion hop over a compact edge slice (int64 ``esrc``/``edst``)."""
    a, b = (edst, esrc) if reverse else (esrc, edst)
    if counting:
        msg = torch.where(emask[None, :], F[:, a] * eweight[None, :], 0)
        return torch.zeros_like(F).index_add_(1, b, msg)
    msg = (F[:, a] & emask[None, :]).to(torch.int32)
    hits = torch.zeros(F.shape, dtype=torch.int32, device=F.device)
    return hits.index_add_(1, b, msg) > 0


def _hop_segment_rows(F, esrc, edst, emask, eweight, *, counting: bool):
    """Row-parameterized segment hop: every frontier row carries its *own*
    ``[blk, E]`` edge operands (int64 ``esrc``/``edst``), so rows of
    different plans of one structural class share one program
    (:class:`~repro_torch.core.plan.SharedProgram`).  Direction is folded
    into the operands.  For rows whose operands repeat one plan's slice this
    is exactly :func:`_hop_segment`: the same gather/scatter targets and
    integer addends per row."""
    src_vals = torch.gather(F, 1, esrc)
    if counting:
        msg = torch.where(emask, src_vals * eweight, 0)
        return torch.zeros_like(F).scatter_add_(1, edst, msg)
    msg = (src_vals & emask).to(torch.int32)
    hits = torch.zeros(F.shape, dtype=torch.int32, device=F.device)
    return hits.scatter_add_(1, edst, msg) > 0


def _hop_segment_local(F_full, a, b_local, emask, eweight, *, counting: bool,
                       n_loc: int):
    """A shard's half of a sharded segment hop: gather from the all-gathered
    frontier (``F_full`` [blk, N_pad]), scatter into the shard's **local**
    node columns only (``[blk, n_loc]``).  Edges are partitioned by
    scatter-side owner with ``b_local`` localized (int64 ``a``/``b_local``,
    :func:`repro_torch.graphops.distributed.partition_hop_edges`), so no
    cross-shard scatter exists; direction is folded into the operands."""
    shape = (F_full.shape[0], n_loc)
    if counting:
        msg = torch.where(emask[None, :], F_full[:, a] * eweight[None, :], 0)
        return torch.zeros(shape, dtype=F_full.dtype,
                           device=F_full.device).index_add_(1, b_local, msg)
    msg = (F_full[:, a] & emask[None, :]).to(torch.int32)
    hits = torch.zeros(shape, dtype=torch.int32, device=F_full.device)
    return hits.index_add_(1, b_local, msg) > 0


def _hop_segment_rows_local(F_full, a, b_local, emask, eweight, *,
                            counting: bool, n_loc: int):
    """Row-parameterized :func:`_hop_segment_local` (``[blk, Ep]`` operand
    rows: the sharded ``SharedProgram`` hop)."""
    shape = (F_full.shape[0], n_loc)
    src_vals = torch.gather(F_full, 1, a)
    if counting:
        msg = torch.where(emask, src_vals * eweight, 0)
        return torch.zeros(shape, dtype=F_full.dtype,
                           device=F_full.device).scatter_add_(1, b_local, msg)
    msg = (src_vals & emask).to(torch.int32)
    hits = torch.zeros(shape, dtype=torch.int32, device=F_full.device)
    return hits.scatter_add_(1, b_local, msg) > 0


def _hop_dense(F, A, *, counting: bool):
    """``F @ A`` as the reference's int32 product gives it.  Counts take an
    fp64 product (exact while sums stay below 2^53; CUDA has no integer
    matmul) cast through int64, so that they wrap to int32 as the
    reference's do; the bool hop is ``> 0`` of the fp32 product."""
    if counting:
        return (F.to(torch.float64) @ A.to(torch.float64)).to(
            torch.int64).to(torch.int32)
    return matmul_f32(F, A) > 0


def _hop_kernel(F, A, *, counting: bool):
    """The dense hop through the hand-written ``block_spmm`` kernel.  The
    kernel reads F and A in their own types and writes int32 counts or a
    uint8 0/1 frontier directly (no float intermediate), walking only the
    slabs of A that its slab map lists.  The map is built at A's first
    kernel hop and kept on A as ``spmm_slab_map``: a cached adjacency is
    never written in place, and eviction and snapshots carry the map with
    the tensor."""
    from repro_torch.kernels import ops as kops
    F = F.contiguous()
    smap = getattr(A, "spmm_slab_map", None)
    if smap is None:
        smap = A.spmm_slab_map = kops.spmm_slab_map(A)
    if counting:
        return kops.block_spmm(F, A, counting=True, out_dtype=torch.int32,
                               slab_map=smap)
    return kops.block_spmm(F, A, counting=False, out_dtype=torch.uint8,
                           slab_map=smap).view(torch.bool)


def _active(F):
    return F if F.dtype == torch.bool else F > 0


def _hop_cost_per_source(F, deg):
    """Per-frontier-row DBHit vector (int64): 2 storage touches per expanded
    edge.  An exact int64 multiply-sum — CUDA has no integer matmul."""
    return 2 * torch.where(_active(F), deg.to(torch.int64)[None, :], 0).sum(1)


def _hop_cost_rows(F, deg_rows):
    """Per-row DBHit vector with a per-row ``[blk, N]`` degree table: the
    row-parameterized :func:`_hop_cost_per_source` (same int64 sums)."""
    return 2 * torch.where(_active(F), deg_rows.to(torch.int64), 0).sum(1)


def _hop_cost(F, deg):
    """DBHits of expanding this frontier (the per-row vector, summed)."""
    return _hop_cost_per_source(F, deg).sum()


def _active_rows_per_source(F):
    """Per-frontier-row Rows vector."""
    return _active(F).sum(1)


def _active_rows(F):
    return _active(F).sum()


def _init_frontier(ids: torch.Tensor, n: int, counting: bool) -> torch.Tensor:
    """One-hot ``[blk, n]`` frontier for a padded id block (-1 = padding)."""
    blk = ids.shape[0]
    valid = ids >= 0
    cols = torch.where(valid, ids, 0).long()
    F = torch.zeros((blk, n), dtype=torch.int32 if counting else torch.bool,
                    device=ids.device)
    F[torch.arange(blk, device=ids.device), cols] = valid.to(F.dtype)
    return F


def _dense_adjacency(g: PropertyGraph, m: torch.Tensor, counting: bool,
                     reverse: bool) -> torch.Tensor:
    """Dense [N, N] int32 adjacency over the edges selected by mask ``m``:
    summed weights (counting) or 0/1 (bool: the clamp is the scatter-max)."""
    N = g.node_cap
    a, b = (g.edge_dst, g.edge_src) if reverse else (g.edge_src, g.edge_dst)
    flat = a.long() * N + b.long()
    vals = torch.where(m, g.edge_weight, 0) if counting else m.to(torch.int32)
    adj = torch.zeros(N * N, dtype=torch.int32, device=g.device)
    adj.index_add_(0, flat, vals)
    if not counting:
        adj.clamp_(max=1)
    return adj.view(N, N)


# ---------------------------------------------------------------------------
# Engine: session-persistent cache owner
# ---------------------------------------------------------------------------

class ExecEngine:
    """Owns the executor state that outlives a single query or write.

    Every cache entry — compact per-label edge slices, degree vectors and
    dense adjacency tiles — records the :class:`LabelEpochs` epoch of its
    edge label at build time, and a mutation invalidates only the labels it
    touched.  Wildcard (``NO_LABEL``) hops expand over **base** edge labels
    only, through a cached compact all-base-edges index keyed off the base
    generation.  ``hits`` / ``misses`` count cache lookups.
    """

    def __init__(self, g: PropertyGraph, schema: GraphSchema,
                 cfg: Optional[ExecConfig] = None,
                 shard_devices: Optional[Sequence] = None):
        self.g = g
        self.schema = schema
        self.cfg = cfg or ExecConfig()
        self.epochs = LabelEpochs()
        self._edge_cache: Dict[int, Tuple[int, Tuple]] = {}
        # predicate-filtered compact slices: (label_id, preds) -> masked slice
        self._edge_pred_cache: Dict[Tuple, Tuple[int, Tuple]] = {}
        self._deg_cache: Dict[Tuple, Tuple[int, torch.Tensor]] = {}
        self._adj_cache: Dict[Tuple, Tuple[int, torch.Tensor]] = {}
        self._base_mask_cache: Optional[Tuple[Tuple[int, int], np.ndarray]] = None
        self._count_cache: Dict[int, Tuple[Tuple[int, int], int]] = {}
        # sharded (dst-partitioned) hop operands: (label, preds, rev, D) ->
        # (validity, per-shard tensors).  Validity is (label epoch,
        # reset_generation, node_cap): the partition is a function of the
        # node capacity, so arena growth re-partitions everywhere
        self._shard_cache: Dict[Tuple, Tuple[Tuple, Tuple]] = {}
        self._shard_nodes_cache: Optional[Tuple] = None
        self.shard_devices_arg = (None if shard_devices is None
                                  else list(shard_devices))
        self._mesh = None
        # maintenance routing: owner shard -> delta sweeps routed there
        # (views.py records one per drained/maintained view when sharded)
        self.shard_sweeps: Dict[int, int] = {}
        self.hits = 0
        self.misses = 0

    @property
    def device(self) -> torch.device:
        return self.g.device

    # -- invalidation -----------------------------------------------------

    def set_graph(self, g: PropertyGraph,
                  touched_edge_labels: Optional[Iterable[int]] = None) -> None:
        """Swap in a mutated graph.

        ``touched_edge_labels`` lists the edge labels the mutation touched;
        only their entries are evicted — plus wildcard entries iff at least
        one touched label is a *base* label.  ``None`` means the delta is
        unknown — evict everything.
        """
        if g is self.g:
            return
        self.g = g
        if touched_edge_labels is None:
            self.epochs.bump_all()
            self._edge_cache.clear()
            self._edge_pred_cache.clear()
            self._deg_cache.clear()
            self._adj_cache.clear()
            self._count_cache.clear()
            self._shard_cache.clear()
            self._shard_nodes_cache = None
            return
        touched = {int(lid) for lid in touched_edge_labels}
        touches_base = bool(touched - self.schema.view_edge_ids)
        self.epochs.bump(touched, touches_base=touches_base)

        def stale(lid: int) -> bool:
            return lid in touched or (lid == NO_LABEL and touches_base)

        for k in [k for k in self._edge_cache if stale(k)]:
            del self._edge_cache[k]
        for k in [k for k in self._edge_pred_cache if stale(k[0])]:
            del self._edge_pred_cache[k]
        for k in [k for k in self._deg_cache if stale(k[0])]:
            del self._deg_cache[k]
        for k in [k for k in self._adj_cache if stale(k[0])]:
            del self._adj_cache[k]
        for k in [k for k in self._shard_cache if stale(k[0])]:
            del self._shard_cache[k]
        self._shard_nodes_cache = None

    def snapshot(self, g: Optional[PropertyGraph] = None,
                 touched_edge_labels: Optional[Iterable[int]] = None
                 ) -> "ExecEngine":
        """Derived engine sharing every still-valid cache entry (the dicts
        are shallow copies; cached tensors are never written in place)."""
        eng = ExecEngine(self.g, self.schema, self.cfg,
                         shard_devices=self.shard_devices_arg)
        eng.epochs = self.epochs.snapshot()
        eng._edge_cache = dict(self._edge_cache)
        eng._edge_pred_cache = dict(self._edge_pred_cache)
        eng._deg_cache = dict(self._deg_cache)
        eng._adj_cache = dict(self._adj_cache)
        eng._base_mask_cache = self._base_mask_cache
        eng._count_cache = dict(self._count_cache)
        eng._shard_cache = dict(self._shard_cache)
        eng._mesh = self._mesh
        if g is not None:
            eng.set_graph(g, touched_edge_labels)
        return eng

    def cached_edge_labels(self) -> set:
        """Labels with a live compact-slice entry (engine-test introspection)."""
        return {lid for lid, (ep, _) in self._edge_cache.items()
                if ep == self.epochs.of(lid)}

    # -- epoch-checked lookup ---------------------------------------------

    def _lookup(self, cache: Dict, key, label_id: int, build):
        ep = self.epochs.of(label_id)
        ent = cache.get(key)
        if ent is not None and ent[0] == ep:
            self.hits += 1
            return ent[1]
        self.misses += 1
        val = build()
        cache[key] = (ep, val)
        return val

    def label_edges(self, label_id: int,
                    preds: Tuple[PropPred, ...] = ()):
        """Per-label compact edge index ``(src, dst, weight, mask)``: int64
        endpoint indices, int32 weights, bool mask.  ``NO_LABEL`` returns the
        all-base-edges index.  With ``preds`` the mask is additionally
        filtered to edges satisfying every predicate, cached per
        (label, preds) under the same label epoch."""
        ent = self._lookup(self._edge_cache, label_id, label_id,
                           lambda: self._build_label_edges(label_id))
        if not preds:
            return ent[:4]

        def build_pred():
            esrc, edst, ew, emask, eids = ent
            pm = torch.from_numpy(
                gathered_pred_mask(self.g.edge_props, preds, eids))
            return (esrc, edst, ew, emask & pm.to(self.device))

        return self._lookup(self._edge_pred_cache, (label_id, preds),
                            label_id, build_pred)

    def _base_keep_mask(self) -> np.ndarray:
        """Host bool [E_cap]: alive edges carrying a *base* edge label,
        memoized on (base_generation, edge_cap)."""
        key = (self.epochs.of(NO_LABEL), self.g.edge_cap)
        if self._base_mask_cache is not None \
                and self._base_mask_cache[0] == key:
            return self._base_mask_cache[1]
        alive = host(self.g.edge_alive)
        if self.schema.view_edge_ids:
            base_ids = np.asarray(self.schema.base_edge_label_ids(), np.int32)
            mask = alive & np.isin(host(self.g.edge_label), base_ids)
        else:
            mask = alive
        self._base_mask_cache = (key, mask)
        return mask

    def _build_label_edges(self, label_id: int):
        """Compact slice on the device + the arena edge ids behind it, in
        slice order (the ids align property columns with the slice)."""
        from repro_torch.graphops.csr import compact_coo
        if label_id == NO_LABEL:
            keep = self._base_keep_mask()
        else:
            keep = (host(self.g.edge_alive)
                    & (host(self.g.edge_label) == label_id))
        src, dst, w, eids = compact_coo(host(self.g.edge_src),
                                        host(self.g.edge_dst),
                                        host(self.g.edge_weight), keep)
        dev = self.device
        return (torch.from_numpy(src.astype(np.int64)).to(dev),
                torch.from_numpy(dst.astype(np.int64)).to(dev),
                torch.from_numpy(w.astype(np.int32)).to(dev),
                torch.ones(src.shape[0], dtype=torch.bool, device=dev),
                eids)

    def _edge_mask_for(self, label_id: int) -> torch.Tensor:
        """Arena-wide bool mask for ``label_id``; wildcard is base-only."""
        if label_id == NO_LABEL:
            return torch.from_numpy(self._base_keep_mask()).to(self.device)
        return self.g.edge_mask(label_id)

    def label_edge_count(self, label_id: int) -> int:
        """Number of alive edges carrying ``label_id`` (wildcard: base only),
        cached per (label epoch, reset generation); outside the
        ``hits``/``misses`` counters (planner bookkeeping)."""
        key = (self.epochs.of(label_id), self.epochs.reset_generation)
        ent = self._count_cache.get(label_id)
        if ent is not None and ent[0] == key:
            return ent[1]
        if label_id == NO_LABEL:
            n = int(self._base_keep_mask().sum())
        else:
            n = int(np.sum(host(self.g.edge_alive)
                           & (host(self.g.edge_label) == label_id)))
        self._count_cache[label_id] = (key, n)
        return n

    def _pred_edge_mask(self, label_id: int,
                        preds: Tuple[PropPred, ...]) -> torch.Tensor:
        m = self._edge_mask_for(label_id)
        if preds:
            m = m & edge_pred_mask(self.g, preds)
        return m

    def deg(self, label_id: int, reverse: bool,
            preds: Tuple[PropPred, ...] = ()) -> torch.Tensor:
        def build():
            m = self._pred_edge_mask(label_id, preds).to(torch.int32)
            col = self.g.edge_dst if reverse else self.g.edge_src
            return torch.zeros(self.g.node_cap, dtype=torch.int32,
                               device=self.device).index_add_(0, col.long(), m)
        return self._lookup(self._deg_cache, (label_id, reverse, preds),
                            label_id, build)

    def adj(self, label_id: int, counting: bool, reverse: bool,
            preds: Tuple[PropPred, ...] = ()) -> torch.Tensor:
        return self._lookup(
            self._adj_cache, (label_id, counting, reverse, preds), label_id,
            lambda: _dense_adjacency(self.g,
                                     self._pred_edge_mask(label_id, preds),
                                     counting, reverse))

    # -- sharded execution (DESIGN.md §12) --------------------------------

    @property
    def n_shards(self) -> int:
        return max(int(self.cfg.data_shards), 1)

    def mesh(self) -> np.ndarray:
        """The ``(data_shards, 1)`` grid of devices sharded plans run on:
        the ``shard_devices`` the engine was given, else ``["cpu"] * N`` for
        a session on the host, else the first N visible cards (raising when
        fewer are visible).  Built lazily, so an unsharded session never
        asks for one."""
        if self._mesh is None or self._mesh.shape[0] != self.n_shards:
            from repro_torch.launch.mesh import make_host_mesh
            devices = self.shard_devices_arg
            if devices is None and self.device.type == "cpu":
                devices = ["cpu"] * self.n_shards
            self._mesh = make_host_mesh(n_data=self.n_shards,
                                        devices=devices)
        return self._mesh

    def shard_devices(self) -> list:
        """Shard ``s``'s device, for each shard."""
        return list(self.mesh()[:, 0])

    def node_pad(self) -> int:
        """Node-column capacity padded to a shard multiple; ``n_loc =
        node_pad // n_shards`` columns live on each shard.  Pad columns are
        dead (no edge scatters there, sources never select them)."""
        return max(round_up(self.g.node_cap, self.n_shards), self.n_shards)

    def _shard_validity(self, label_id: int) -> Tuple[int, int, int]:
        """Sharded entries revalidate on the label epoch, the reset
        generation and node_cap: the partition is a function of the node
        capacity, and reset fences (arena growth, external swaps) must
        invalidate every shard's cached slices."""
        return (self.epochs.of(label_id), self.epochs.reset_generation,
                self.g.node_cap)

    def shard_put_edges(self, arr) -> Tuple[torch.Tensor, ...]:
        """A ``[D, ...]`` stacked per-shard array as a tuple of tensors,
        row ``s`` on shard ``s``'s device."""
        t = torch.as_tensor(arr)
        return tuple(t[s].to(dev) for s, dev in
                     enumerate(self.shard_devices()))

    def shard_put_cols(self, col: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """A ``[N_pad, ...]`` node-column tensor split into each shard's
        ``n_loc`` local columns, each on its shard's device."""
        n_loc = col.shape[0] // self.n_shards
        return tuple(col[s * n_loc:(s + 1) * n_loc].to(dev)
                     for s, dev in enumerate(self.shard_devices()))

    def shard_put_mask_stack(self, arr: torch.Tensor
                             ) -> Tuple[torch.Tensor, ...]:
        """A ``[M, N_pad]`` member-mask stack split into each shard's
        ``[M, n_loc]`` columns (members replicated)."""
        n_loc = arr.shape[1] // self.n_shards
        return tuple(arr[:, s * n_loc:(s + 1) * n_loc].to(dev)
                     for s, dev in enumerate(self.shard_devices()))

    def sharded_label_edges(self, label_id: int, reverse: bool,
                            preds: Tuple[PropPred, ...] = ()):
        """Dst-partitioned hop operands for one (label, preds, direction):
        ``(a, b_local, w, mask, deg)``, each a tuple with shard ``s``'s
        ``[Ep]`` row (deg ``[N_pad]``) on shard ``s``'s device.  Partitioned
        by the hop's scatter-side endpoint (dst, or src for reverse hops) on
        the host (:func:`~repro_torch.graphops.distributed.
        partition_hop_edges`); ``deg`` is the shard's partial degree vector,
        the shards' partials summing to :meth:`deg` exactly.  Cached per
        (label, preds, direction) under :meth:`_shard_validity`."""
        from repro_torch.graphops.distributed import partition_hop_edges
        key = (label_id, preds, reverse, self.n_shards)
        validity = self._shard_validity(label_id)
        ent = self._shard_cache.get(key)
        if ent is not None and ent[0] == validity:
            self.hits += 1
            return ent[1]
        self.misses += 1
        esrc, edst, ew, emask = host(*self.label_edges(label_id, preds))
        src, dst, w = esrc[emask], edst[emask], ew[emask]
        gather, scatter = (dst, src) if reverse else (src, dst)
        a, b_local, w, m, deg = partition_hop_edges(
            gather, scatter, w, self.node_pad(), self.n_shards)
        val = tuple(self.shard_put_edges(x) for x in (
            a.astype(np.int64), b_local.astype(np.int64), w, m, deg))
        self._shard_cache[key] = (validity, val)
        return val

    def sharded_node_data(self, nprop_names: Tuple[str, ...]):
        """Node columns padded to :meth:`node_pad` and split by shard:
        ``(label, key, alive, props)``, each a tuple of per-shard
        ``[n_loc]`` tensors.  Cached per graph object identity (every write
        makes a new graph: mutation clones what it changes); pad columns
        are dead (alive=False) and unreachable."""
        n_pad = self.node_pad()
        cached = self._shard_nodes_cache
        if (cached is not None and cached[0] is self.g
                and cached[1] == nprop_names and cached[2] == n_pad):
            return cached[3]
        g = self.g

        def split(col):
            return self.shard_put_cols(torch.nn.functional.pad(
                col, (0, n_pad - g.node_cap)))

        val = (split(g.node_label), split(g.node_key), split(g.node_alive),
               tuple(split(g.node_prop_col(n)) for n in nprop_names))
        self._shard_nodes_cache = (g, nprop_names, n_pad, val)
        return val

    def padded_node_mask(self, m: torch.Tensor) -> torch.Tensor:
        """A ``[node_cap]`` bool node mask padded with False to
        :meth:`node_pad` (on its device: the sharded SharedProgram stacks
        member masks, then splits the stack by
        :meth:`shard_put_mask_stack`)."""
        return torch.nn.functional.pad(m, (0, self.node_pad() - m.shape[0]))

    def shard_owner_of(self, label_id: int) -> int:
        from repro_torch.graphops.distributed import shard_owner
        return shard_owner(label_id, self.n_shards)

    def note_shard_sweep(self, label_id: int) -> None:
        """Record one maintenance delta sweep routed to a label's owner
        shard (views.py calls this per drained/maintained view when
        sharded)."""
        owner = self.shard_owner_of(label_id)
        self.shard_sweeps[owner] = self.shard_sweeps.get(owner, 0) + 1


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

class PathExecutor:
    """Evaluates :class:`PathPattern` s against a :class:`PropertyGraph`.

    Evaluation state (frontier blocking, metrics) lives here; cached derived
    state lives in the :class:`ExecEngine`.  ``PathExecutor(engine=...)``
    binds to a shared persistent engine; ``PathExecutor(g, schema, cfg)``
    creates a private one.  Every hop syncs its DBHit/Rows to the host.
    """

    def __init__(self, g: Optional[PropertyGraph] = None,
                 schema: Optional[GraphSchema] = None,
                 cfg: Optional[ExecConfig] = None,
                 engine: Optional[ExecEngine] = None):
        if engine is None:
            if g is None or schema is None:
                raise ValueError("PathExecutor needs (g, schema) or engine=")
            engine = ExecEngine(g, schema, cfg)
        self.engine = engine
        self.schema = engine.schema if schema is None else schema
        self.cfg = cfg or engine.cfg

    @property
    def g(self) -> PropertyGraph:
        return self.engine.g

    def invalidate(self, g: PropertyGraph):
        """Swap in a mutated graph (unknown delta: drops all caches)."""
        self.engine.set_graph(g, None)

    # -- primitive hop ----------------------------------------------------

    def _hop_ops(self, rel_label_id: int, direction: Direction,
                 counting: bool, preds: Tuple[PropPred, ...] = ()):
        """One hop's operands, fetched (and built, on a cache miss) once for
        a whole hop range: ``(reverse, degrees or None, the dense adjacency
        or the label's edges)`` a direction."""
        dirs = ([False] if direction is Direction.OUT
                else [True] if direction is Direction.IN
                else [False, True])
        eng = self.engine
        ops = []
        for rev in dirs:
            deg = (eng.deg(rel_label_id, rev, preds)
                   if self.cfg.collect_metrics else None)
            if self.cfg.backend == "dense":
                arg = eng.adj(rel_label_id, counting, rev, preds)
            else:
                arg = eng.label_edges(rel_label_id, preds)
            ops.append((rev, deg, arg))
        return ops

    def _hop(self, F, ops, counting: bool, metrics: Metrics):
        out = None
        for rev, deg, arg in ops:
            if deg is not None:
                metrics.db_hits += int(_hop_cost(F, deg))
            if self.cfg.backend == "dense":
                hop = _hop_kernel if self.cfg.use_kernel else _hop_dense
                nxt = hop(F, arg, counting=counting)
            else:
                esrc, edst, ew, emask = arg
                nxt = _hop_segment(F, esrc, edst, emask, ew,
                                   counting=counting, reverse=rev)
            out = nxt if out is None else (out + nxt if counting else out | nxt)
        if self.cfg.collect_metrics:
            metrics.rows += int(_active_rows(out))
        return out

    def _node_filter(self, F, label_id: int, key: Optional[int],
                     preds: Tuple[PropPred, ...] = ()):
        mask = self.g.node_mask(label_id, key)
        if preds:
            mask = mask & node_pred_mask(self.g, preds)
        if F.dtype == torch.bool:
            return F & mask[None, :]
        return torch.where(mask[None, :], F, 0)

    # -- hop-range expansion ----------------------------------------------

    def _expand_rel(self, F, rel: RelPat, counting: bool, metrics: Metrics):
        lid = self.schema.edge_label_id(rel.label)
        preds = normalize_preds(rel.preds)
        lo, hi = rel.min_hops, rel.max_hops
        ops = (self._hop_ops(lid, rel.direction, counting, preds)
               if hi != 0 else [])
        if hi != INF_HOPS:
            # bounded: acc = sum/or over k in [lo, hi] (lo may be 0: identity)
            acc = F if lo == 0 else None
            cur = F
            for k in range(1, hi + 1):
                cur = self._hop(cur, ops, counting, metrics)
                if k >= lo:
                    if acc is None:
                        acc = cur
                    else:
                        acc = acc + cur if counting else acc | cur
                if not counting and not host_flag(cur.any()):
                    break
            return acc if acc is not None else torch.zeros_like(F)
        # unbounded: boolean reach only (counting of infinite walk families
        # is undefined); the caller has already forced counting=False.
        assert not counting
        cur = F
        for _ in range(max(lo, 0)):
            cur = self._hop(cur, ops, False, metrics)
        reach = cur
        frontier = cur
        # traced: the span ``exec.closure``, ``iters`` the hops it ran and
        # its flag reads its ``pulls``
        with trace.span("exec.closure", iters=0):
            for _ in range(self.cfg.max_closure_iters):
                if not host_flag(frontier.any()):
                    break
                nxt = self._hop(frontier, ops, False, metrics)
                frontier = nxt & ~reach
                reach = reach | nxt
                trace.add("iters", 1)
            else:
                raise RuntimeError(
                    "closure did not converge within max_closure_iters")
        return reach

    # -- public API --------------------------------------------------------

    def source_ids(self, label_id: int, key: Optional[int],
                   preds: Tuple[PropPred, ...] = ()) -> np.ndarray:
        m = self.g.node_mask(label_id, key)
        if preds:
            m = m & node_pred_mask(self.g, preds)
        return np.flatnonzero(host(m)).astype(np.int32)

    def run_path(self, path: PathPattern, counting: Optional[bool] = None,
                 sources: Optional[np.ndarray] = None) -> ReachResult:
        """Evaluate a full path pattern; returns per-source reach + metrics:
        int32 walk counts, or bool reachability under set semantics (the
        rows a fused :class:`~repro_torch.core.plan.CompiledPlan` gives)."""
        if counting is None:
            counting = not any(r.unbounded for r in path.rels)
        if counting and any(r.unbounded for r in path.rels):
            counting = False  # set semantics for unbounded patterns

        start = path.start
        start_lid = self.schema.node_label_id(start.label)
        if sources is None:
            sources = self.source_ids(start_lid, start.key,
                                      normalize_preds(start.preds))
        sources = np.asarray(sources, np.int32)
        metrics = Metrics(db_hits=int(sources.shape[0]),
                          rows=int(sources.shape[0]))

        S = sources.shape[0]
        N = self.g.node_cap
        blk = self.cfg.src_block
        S_pad = max(round_up(S, blk), blk)
        padded = np.full(S_pad, -1, np.int32)
        padded[:S] = sources

        out_rows = []
        for b0 in range(0, S_pad, blk):
            ids = torch.from_numpy(padded[b0:b0 + blk]).to(self.g.device)
            F = _init_frontier(ids, N, counting)
            # start-node constraints are implied by source selection; interior
            # and end node constraints interleave with rel expansion:
            for i, rel in enumerate(path.rels):
                F = self._expand_rel(F, rel, counting, metrics)
                nxt = path.nodes[i + 1]
                F = self._node_filter(
                    F, self.schema.node_label_id(nxt.label), nxt.key,
                    normalize_preds(nxt.preds))
            out_rows.append(host(F))
        reach = np.concatenate(out_rows, axis=0)[:S].astype(
            np.int32 if counting else np.bool_, copy=False)
        return ReachResult(src_ids=sources, reach=reach, counting=counting,
                           metrics=metrics)

    def run_query(self, query: Query) -> ReachResult:
        counting = False if query.force_bool else None
        return self.run_path(query.path, counting=counting)

"""Continuous-batching serve scheduler for graph reads (DESIGN.md §10).

A production deployment of MV4PG serves *many logical clients at once*:
thousands of concurrent ``MATCH`` requests that hash to a handful of plan
fingerprints (the same amortization bet the paper makes about data work and
``core/plan.py`` makes about compilation).  The scheduler admits and evicts
tickets without stalling the batch:

* **Label-scoped write fences** — each :class:`~repro_torch.core.graph.WriteBatch`
  gets a :class:`FenceScope` (edge labels it may touch — closed over view
  maintenance — node properties it writes, node creation/deletion flags).
  A read conflicts with a pending fence only if their scopes intersect, so
  reads submitted *after* a fence on disjoint labels hoist into the current
  window instead of waiting for it (one-directional: a fence never applies
  before an earlier-submitted read executes).
* **Cross-window result memo** — every executed binding's
  :class:`~repro_torch.core.plan.RowResult` (rows + per-row DBHit/Rows vectors) is
  memoized under its (fingerprint, use-views, binding) key.  A later
  identical read is answered for free while no conflicting fence has
  applied; fences evict exactly the entries their scope invalidates (label
  staleness is additionally caught by plan-object identity through the
  session plan cache's epoch machinery).
* **Row-subsumption gather** — a point binding whose sources are rows of the
  group's unbound (default-sources) execution is answered by *gathering*
  those rows and their per-row metric entries instead of packing new rows:
  every kernel in the fused programs is row-local, so the gathered result is
  bit-for-bit what a solo execution returns.
* **Cross-fingerprint structural sharing** — groups whose plans share a
  structure key (:meth:`CompiledPlan.structure_key`: same step kinds, hop
  bounds, direction counts, all-segment backends; labels/predicates demoted
  to operands) bucket into one :class:`~repro_torch.core.plan.SharedProgram`
  batch, with per-row member indices selecting each row's operand stack.
  Buckets also partition on log2 edge-slice scale so padding never inflates
  a member's per-row work by more than 2x.
* **Admission deadlines + adaptive windows** — tickets carry an admission
  deadline (``admit_by``, in executed windows); eligible tickets are
  admitted oldest-deadline-first up to an adaptive window limit that grows
  with queue depth and backs off when observed per-ticket group latency
  spikes.  A ticket admitted after its deadline counts a ``deadline_miss``;
  deadline ordering makes starvation impossible (an unserved ticket's
  deadline only gets *relatively* older).
* **Async client API** — ``submit()`` returns an awaitable
  :class:`ServeTicket`; ``step()`` advances the scheduler by one window or
  fence, ``poll()``/``result()`` observe or pump a single ticket, ``run()``
  drains synchronously, and ``drain()`` is the asyncio-friendly drain that
  yields to the event loop between steps.

Serving correctness contract (unchanged from §9): every ticket receives
*exactly* — rows and DBHit/Rows metrics — what the same request sequence
returns through per-query :meth:`GraphSession.query` / ``apply_writes``
calls in submission order.  Hoisting, memoization and gathering preserve it
because a read only crosses or reuses state across fences proven (by scope)
not to affect its plan's operands, masks, or default-source selection.
While tickets are pending, writes must go through :meth:`submit_writes` —
the single-writer contract fences rely on.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Deque, Dict, FrozenSet, List, Optional,
                    Tuple, Union)

import numpy as np

from repro_torch.core import graph as G
from repro_torch.core.executor import ReachResult
from repro_torch.core.online_selection import (
    OnlineSelectionConfig, OnlineSelector,
)
from repro_torch.core.parser import parse_query, query_fingerprint
from repro_torch.core.pattern import Query
from repro_torch.core.plan import (
    CompiledPlan, ExpandStep, RowResult, block_sizes,
)
from repro_torch.core.schema import NEVER_LABEL, NO_LABEL
from repro_torch.utils import host

if TYPE_CHECKING:  # pragma: no cover - typing only (avoids an import cycle)
    from repro_torch.core.views import BatchResult, GraphSession


@dataclass
class ServeConfig:
    """Scheduler knobs (the reference engine's defaults)."""

    window_init: int = 64        # starting admission window (tickets)
    window_min: int = 16
    window_max: int = 4096
    patience: int = 4            # default admission deadline, in windows
    latency_smoothing: float = 0.5   # EWMA weight of the newest window
    latency_backoff: float = 2.0     # shrink window when per-ticket latency
    #                                  exceeds backoff * EWMA
    structural_sharing: bool = True  # cross-fingerprint SharedProgram buckets
    adaptive_blocks: bool = True     # pow2 sub-block sizing (serve path only)
    reuse_results: bool = True       # cross-window execution memo
    # enable online view selection (core/online_selection.py): the engine
    # feeds answered reads/applied fences to an OnlineSelector and lets it
    # create/drop budget-bound views at quiescent points between windows
    online_selection: Optional["OnlineSelectionConfig"] = None


@dataclass
class EmbedResult:
    """Typed answer of an embedding read (DESIGN.md §14)."""

    node_ids: np.ndarray       # [n] the requested ids, as submitted
    embeddings: np.ndarray     # [n, dim] f32; zero rows for off-view ids
    view: str                  # the backing view's name
    version: int               # subgraph structure version answered from


@dataclass
class ServeTicket:
    """One submitted request; filled in when the scheduler answers it.

    Awaitable: ``await ticket`` yields to the event loop until the ticket is
    done (something must be driving the engine concurrently — see
    :meth:`ServeEngine.drain`)."""

    uid: int
    kind: str                                  # "read" | "write" | "embed"
    query: Optional[Query] = None
    use_views: Optional[bool] = None           # None: session auto_optimize
    sources: Optional[np.ndarray] = None       # explicit source binding
    batch: Optional[G.WriteBatch] = None       # write fences only
    result: Optional[ReachResult] = None
    write_result: Optional["BatchResult"] = None
    embed: Optional[str] = None                # embedder name (embed reads)
    node_ids: Optional[np.ndarray] = None      # embed reads only
    embed_result: Optional[EmbedResult] = None
    window: int = -1                           # epoch the ticket ran in
    window_seq: int = -1                       # executed-window index
    admit_by: int = 0                          # admission deadline (window_seq)
    via: str = ""                              # exec | dedup | gather | memo
    hoisted: bool = False                      # executed ahead of a fence
    scope: Optional["FenceScope"] = None       # write fences only

    @property
    def done(self) -> bool:
        return (self.result is not None or self.write_result is not None
                or self.embed_result is not None)

    def __await__(self):
        while not self.done:
            yield
        if self.kind == "read":
            return self.result
        if self.kind == "embed":
            return self.embed_result
        return self.write_result


@dataclass(frozen=True)
class FenceScope:
    """What a pending write fence may invalidate, computed at submit time.

    ``edge_labels`` is closed over view maintenance: if the fence can touch
    a view's inputs (its match labels or the node properties its predicates
    read), the view's materialized label is in scope too, to a fixpoint.
    ``global_`` is the conservative escape hatch: node deletes (which kill
    incident edges and shrink default-source selections), deletes of slots
    that are dead or already pending deletion (their identity at apply time
    is unknowable), and writes touching view-owned edge slots."""

    global_: bool = False
    edge_labels: FrozenSet[int] = frozenset()
    # (node label id, prop) pairs the fence writes; NO_LABEL pairs with any
    # label (a prop set on a node whose label the scope can't pin down)
    node_props: FrozenSet[Tuple[int, str]] = frozenset()
    creates_nodes: bool = False
    interns_labels: bool = False    # creates edges under a brand-new label
    # views impacted by this fence whose effective refresh policy is
    # non-exact: applying the fence only queues their deltas, so their
    # labels stay out of edge_labels — a read touching one must instead
    # order behind the fence and drain (or prove itself within a staleness
    # bound and hoist)
    deferred_views: FrozenSet[str] = frozenset()
    write_ops: int = 0              # batch op count (staleness estimation)


_GLOBAL_SCOPE = FenceScope(global_=True)


def _prop_pairs_conflict(reads: FrozenSet[Tuple[int, str]],
                         writes: FrozenSet[Tuple[int, str]]) -> bool:
    """Do any (node label, prop) read/write pairs collide?  ``NO_LABEL`` (and
    the not-yet-interned ``NEVER_LABEL``) act as wildcards on either side."""
    by_prop: Dict[str, set] = {}
    for lid, p in reads:
        by_prop.setdefault(p, set()).add(lid)
    for lid, p in writes:
        lids = by_prop.get(p)
        if lids is None:
            continue
        if lid < 0 or lid in lids or any(l < 0 for l in lids):
            return True
    return False


@dataclass
class ServeStats:
    """Cumulative serving counters."""

    windows: int = 0           # batch windows executed
    write_batches: int = 0     # fences applied
    queries: int = 0           # read tickets answered
    groups: int = 0            # (fingerprint, use_views) groups executed
    executions: int = 0        # unique source bindings actually evaluated
    rows: int = 0              # unique frontier rows packed into blocks
    blocks: int = 0            # fused device-program invocations
    block_capacity: int = 0    # total row slots launched
    group_sizes: List[int] = field(default_factory=list)
    window_sizes: List[int] = field(default_factory=list)  # tickets/window
    block_sizes: List[int] = field(default_factory=list)   # slots/block
    deadline_misses: int = 0   # tickets admitted after their deadline
    memo_hits: int = 0         # tickets answered from the cross-window memo
    gathers: int = 0           # tickets answered by row-subsumption gather
    hoisted: int = 0           # tickets answered ahead of a pending fence
    shared_groups: int = 0     # groups run through a shared structural program
    warm_pool_hits: int = 0    # singleton groups riding a pooled shared shape
    drains: int = 0            # read-triggered targeted view drains
    auto_creates: int = 0      # views created by the online selector
    auto_drops: int = 0        # views dropped by the online selector
    embed_reads: int = 0       # embedding lookups answered
    embed_refreshes: int = 0   # embedder table recomputes (view changed)

    @property
    def mean_group_size(self) -> float:
        """Queries per group — the cross-query amortization factor."""
        return self.queries / self.groups if self.groups else 0.0

    @property
    def mean_window_size(self) -> float:
        return (sum(self.window_sizes) / len(self.window_sizes)
                if self.window_sizes else 0.0)

    @property
    def share_rate(self) -> float:
        """Fraction of executed groups served by a shared structural
        program rather than their own per-fingerprint program."""
        return self.shared_groups / self.groups if self.groups else 0.0

    @property
    def occupancy(self) -> float:
        """Unique packed rows per launched row slot.  Honest under dedup:
        tickets answered by dedup/memo/gather contribute no rows and no
        slots, so 32 identical queries packing one binding score the
        binding's own occupancy, not 32x."""
        return self.rows / self.block_capacity if self.block_capacity else 0.0

    def summary(self) -> str:
        return (f"windows={self.windows} queries={self.queries} "
                f"groups={self.groups} executions={self.executions} "
                f"mean_group={self.mean_group_size:.1f} "
                f"mean_window={self.mean_window_size:.1f} "
                f"occupancy={self.occupancy:.2f} blocks={self.blocks} "
                f"memo={self.memo_hits} gathers={self.gathers} "
                f"hoisted={self.hoisted} share_rate={self.share_rate:.2f} "
                f"warm_pool={self.warm_pool_hits} "
                f"deadline_misses={self.deadline_misses} "
                f"writes={self.write_batches} drains={self.drains}")


class _Group:
    """One (plan, use-views) read group inside a window."""

    __slots__ = ("plan", "base", "tickets", "spec_idx", "spec_sources",
                 "ticket_spec", "unbound_idx")

    def __init__(self, plan: CompiledPlan, base):
        self.plan = plan
        self.base = base                      # (fingerprint, use) memo key
        self.tickets: List[ServeTicket] = []
        self.spec_idx: Dict[Optional[bytes], int] = {}
        self.spec_sources: List[np.ndarray] = []
        self.ticket_spec: List[int] = []
        self.unbound_idx: Optional[int] = None


class ServeEngine:
    """Continuous-batching read serving + label-scoped write fences over one
    :class:`~repro_torch.core.views.GraphSession`.

    Usage::

        eng = sess.serve()
        tickets = [eng.submit(q, sources=np.array([c])) for c in clients]
        eng.submit_writes(WriteBatch().create_edge(u, v, "knows"))
        after = eng.submit(q)        # sees the write: conflicting scope
        eng.run()                    # drain; tickets now carry results

    or asynchronously::

        async def client(q):
            return await eng.submit(q)
        results = await asyncio.gather(client(q1), client(q2), eng.drain())
    """

    def __init__(self, session: "GraphSession",
                 config: Optional[ServeConfig] = None):
        self.sess = session
        self.cfg = config or ServeConfig()
        self.epoch = 0                     # completed write fences
        self.stats = ServeStats()
        self.window_limit = self.cfg.window_init
        self._queue: Deque[ServeTicket] = collections.deque()
        self._uid = 0
        self._window_seq = 0               # executed windows
        self._lat_ewma: Optional[float] = None
        # (fingerprint, use, binding-bytes|None) -> (plan, RowResult)
        self._memo: Dict[tuple, Tuple[CompiledPlan, RowResult]] = {}
        # cross-window warm pool of shared-program bucket shapes
        # (structure_key, share_scales): once a shape has bucketed, later
        # windows route even a *singleton* group of that shape through the
        # session's SharedProgram, so a recurring shape keeps one operand
        # layout (pow2-padded members and edge stacks) across windows.  The
        # reference's pool reuses jitted executables; this one is kept so
        # that ``warm_pool_hits`` and ``share_rate`` count what the
        # reference's count
        self._bucket_pool: set = set()
        # the pool keys by (structure_key, share_scales) only — no
        # view_set_generation — so across create_view/drop_view churn stale
        # shape keys would otherwise accumulate forever (correctness is
        # unaffected: SharedProgram re-gathers operands per execution and
        # the memo is plan-identity-checked, but the pool would keep routing
        # dead shapes of dropped-view plans through the shared program).
        # Track the generation it was filled under and reset on churn.
        self._bucket_pool_gen = session.view_set_generation
        self._pending_dead: set = set()    # edge slots pending deletion
        self._pending_dead_nodes: set = set()  # node slots pending deletion
        # online view selection: observe_* feeds are pure bookkeeping; the
        # selector only mutates the catalog inside step() between windows
        self.selector = (OnlineSelector(session, self.cfg.online_selection)
                         if self.cfg.online_selection is not None else None)
        # embedding-read operators (DESIGN.md §14): name -> duck-typed
        # embedder (.view_name, .refresh() -> bool, .lookup(ids), .version)
        self._embedders: Dict[str, object] = {}
        # the session notifies us at drain/drop points (targeted memo
        # eviction for content that changes outside any fence application)
        session._serve_engines.add(self)

    # -------------------------------------------------------------- submit

    def submit(self, q: Union[str, Query], use_views: Optional[bool] = None,
               sources: Optional[np.ndarray] = None,
               deadline: Optional[int] = None) -> ServeTicket:
        """Enqueue one read; returns its awaitable ticket.

        ``sources`` is the per-client binding: an explicit source-id array
        evaluated under the :meth:`GraphSession.query` ``sources=`` contract
        (caller-owned; skips the start-node filter).  ``deadline`` is the
        admission deadline in executed windows from now (default
        ``ServeConfig.patience``); tickets are admitted oldest-deadline
        first."""
        if isinstance(q, str):
            q = parse_query(q)
        t = ServeTicket(
            uid=self._next_uid(), kind="read", query=q, use_views=use_views,
            sources=None if sources is None
            else np.asarray(sources, np.int32),
            admit_by=self._window_seq + (self.cfg.patience
                                         if deadline is None else deadline))
        self._queue.append(t)
        return t

    def submit_writes(self, batch: G.WriteBatch) -> ServeTicket:
        """Enqueue a write fence: every read submitted before it runs
        against the pre-write snapshot; a read submitted after it sees the
        write unless its plan provably doesn't (disjoint :class:`FenceScope`),
        in which case it may be served early — the result is identical by
        construction."""
        t = ServeTicket(uid=self._next_uid(), kind="write", batch=batch,
                        scope=self._fence_scope(batch))
        self._pending_dead.update(int(e) for e in batch.edge_deletes)
        self._pending_dead_nodes.update(int(n) for n in batch.node_deletes)
        self._queue.append(t)
        return t

    def register_embedder(self, embedder, name: Optional[str] = None) -> str:
        """Register an embedding-read operator (e.g. a
        view-fed GNN embedder, ROADMAP A9).  Duck-typed: anything with
        ``view_name``, ``refresh() -> bool``, ``lookup(ids) -> [n, d]`` and
        ``version`` works; the engine never imports the model stack.
        Returns the name :meth:`submit_embed` addresses it by (defaults to
        the backing view's name)."""
        name = name or embedder.view_name
        if embedder.view_name not in self.sess.views:
            raise ValueError(
                f"embedder {name!r} backs view {embedder.view_name!r}, "
                f"which does not exist in this session")
        self._embedders[name] = embedder
        return name

    def submit_embed(self, name: str, node_ids,
                     deadline: Optional[int] = None) -> ServeTicket:
        """Enqueue an embedding lookup against a registered embedder.

        Scheduled like any read: the ticket orders behind every queued
        write fence whose scope can touch the backing view (its label, a
        global fence, or a deferred-maintenance impact), and hoists ahead
        of provably disjoint fences.  The embedder refreshes against the
        view's maintained subgraph before answering, so a lookup after a
        conflicting fence observes the post-write embeddings."""
        if name not in self._embedders:
            raise ValueError(
                f"no embedder {name!r} registered; have "
                f"{sorted(self._embedders) or '(none)'}")
        t = ServeTicket(
            uid=self._next_uid(), kind="embed", embed=name,
            node_ids=np.asarray(node_ids, np.int64),
            admit_by=self._window_seq + (self.cfg.patience
                                         if deadline is None else deadline))
        self._queue.append(t)
        return t

    def _next_uid(self) -> int:
        self._uid += 1
        return self._uid

    @property
    def pending(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------- scoping

    def _fence_scope(self, batch: G.WriteBatch) -> FenceScope:
        """Compute the fence's invalidation scope against the current graph
        + the writes already pending (single-writer: nothing else mutates the
        session while tickets are queued, so submit-time label reads stay
        true until this fence applies)."""
        sess = self.sess
        if batch.node_deletes:
            return _GLOBAL_SCOPE
        g = sess.g
        e_alive = host(g.edge_alive)
        e_lab = host(g.edge_label)
        labels: set = set()
        for eid in list(batch.edge_deletes) + [i for i, _, _
                                               in batch.edge_prop_sets]:
            eid = int(eid)
            if eid in self._pending_dead or not bool(e_alive[eid]):
                # dead or pending-dead slot: its occupant at apply time is
                # unknowable (slots are reused), so scope can't be trusted
                return _GLOBAL_SCOPE
            lid = int(e_lab[eid])
            if sess.schema.is_view_edge_label_id(lid):
                # touching view-owned slots interacts with maintenance's own
                # slot reuse — out of scope analysis, fence everything
                return _GLOBAL_SCOPE
            labels.add(lid)
        interns = False
        for _, _, lbl in batch.edge_creates:
            lid = sess.schema.edge_labels.maybe_id(lbl)
            if lid < 0:
                interns = True     # brand-new label: id unknown until apply
            else:
                labels.add(lid)
        # node-prop writes scope to (node label, prop) pairs so reads over a
        # disjoint node label stay fence-free.  A set on a dead or
        # pending-dead node falls back to global (slot reuse makes the label
        # at apply time unknowable); a create-prop's label comes from the
        # batch itself (un-interned label -> wildcard pair)
        n_alive = host(g.node_alive)
        n_lab = host(g.node_label)
        node_props: set = set()
        for nid, p, _ in batch.node_prop_sets:
            nid = int(nid)
            if nid in self._pending_dead_nodes or not bool(n_alive[nid]):
                return _GLOBAL_SCOPE
            node_props.add((int(n_lab[nid]), p))
        for idx, p, _ in batch.node_create_props:
            lid = sess.schema.node_labels.maybe_id(
                batch.node_creates[int(idx)][0])
            node_props.add((lid if lid >= 0 else NO_LABEL, p))
        # close over view maintenance: a fence touching an exactly-maintained
        # view's inputs rewrites edges under the view's label too.  Views
        # whose effective policy for this batch is non-exact only get their
        # deltas queued — their labels stay out of scope, and the view name
        # goes to deferred_views for the freshness gate instead
        name_of = sess.schema.edge_labels.name_of
        deferred: set = set()
        changed = True
        while changed:
            changed = False
            for view in sess.views.values():
                if view.label_id in labels or view.name in deferred:
                    continue
                v_pairs = frozenset(
                    (sess.schema.node_label_id(n.label), p.prop)
                    for n in view.vdef.match.nodes for p in n.preds)
                hit = _prop_pairs_conflict(v_pairs, frozenset(node_props))
                hit = hit or (interns and any(
                    r.label is None for r in view.vdef.match.rels))
                hit = hit or any(sess._uses_label(view, name_of(lid))
                                 for lid in labels)
                if hit:
                    if sess._effective_mode(view, batch) == "exact":
                        labels.add(view.label_id)
                    else:
                        deferred.add(view.name)
                    changed = True
        return FenceScope(
            global_=False, edge_labels=frozenset(labels),
            node_props=frozenset(node_props),
            creates_nodes=bool(batch.node_creates), interns_labels=interns,
            deferred_views=frozenset(deferred), write_ops=len(batch))

    def _conflicts(self, plan: CompiledPlan, unbound: bool,
                   scope: FenceScope) -> bool:
        """May applying a fence with ``scope`` change what ``plan`` returns
        for a ticket with (``unbound``) default sources?"""
        if scope.global_:
            return True
        labels = {s.label_id for s in plan.steps
                  if isinstance(s, ExpandStep)}
        if labels & scope.edge_labels:
            return True
        if NEVER_LABEL in labels and scope.interns_labels:
            return True    # the fence may intern the label this plan awaits
        if NO_LABEL in labels:
            # wildcard hops span every base label
            if scope.interns_labels:
                return True
            if any(not self.sess.schema.is_view_edge_label_id(lid)
                   for lid in scope.edge_labels):
                return True
        props = set(plan._nprop_pairs)
        if unbound:
            props |= {(plan.start_label_id, p.prop)
                      for p in plan.start_preds}
        if props and scope.node_props \
                and _prop_pairs_conflict(frozenset(props), scope.node_props):
            return True
        if scope.creates_nodes and unbound:
            return True    # new nodes may join the default-source selection
        return False

    # ----------------------------------------------------------- scheduling

    def _plan_for(self, t: ServeTicket) -> Tuple[CompiledPlan, tuple]:
        """Plan identity of a read *at scheduling time* (the view catalog may
        have changed since submission, so use-views resolves here).  Returns
        (plan, memo base key)."""
        sess = self.sess
        use = (sess.auto_optimize if t.use_views is None else t.use_views)
        views = list(sess.views.values()) if (use and sess.views) else []
        plan, _ = sess.planner.plan(t.query, views, sess.view_set_generation)
        fp = query_fingerprint(t.query, sess.schema)
        return plan, (fp, bool(views))

    def _memo_answer(self, t: ServeTicket, plan: CompiledPlan,
                     base: tuple) -> Optional[Tuple[RowResult, str]]:
        """Answer a ticket from the cross-window memo if possible: an exact
        binding hit, or a gather from the memoized unbound execution whose
        rows subsume the ticket's sources."""
        if not self.cfg.reuse_results:
            return None
        key = None if t.sources is None else t.sources.tobytes()
        ent = self._memo.get((base, key))
        if ent is not None:
            if ent[0] is plan:
                return (ent[1], "memo")
            del self._memo[(base, key)]    # superseded plan: stale entry
        if key is not None:
            ent = self._memo.get((base, None))
            if ent is not None and ent[0] is plan \
                    and ent[1].covers(t.sources):
                return (ent[1].gather(t.sources), "gather")
        return None

    def _collect(self):
        """Walk the queue in submission order: classify every read as
        memo-answerable, eligible for the next window (no conflicting fence
        ahead of it), or blocked."""
        scopes: List[FenceScope] = []
        blocked_global = False
        window: List[Tuple[ServeTicket, CompiledPlan, tuple]] = []
        resolved: List[Tuple[ServeTicket, RowResult, str]] = []
        embeds: List[ServeTicket] = []
        for t in self._queue:
            if t.kind == "write":
                scopes.append(t.scope)
                blocked_global = blocked_global or t.scope.global_
                continue
            if blocked_global:
                continue
            if t.kind == "embed":
                if not self._embed_blocked(t, scopes):
                    t.hoisted = bool(scopes)
                    embeds.append(t)
                continue
            plan, base = self._plan_for(t)
            if any(self._conflicts(plan, t.sources is None, sc)
                   for sc in scopes):
                continue
            blocked, need_drain = self._freshness_gate(plan, scopes)
            if blocked:
                continue
            if need_drain:
                # targeted read-triggered drain: refresh exactly the stale
                # views this plan reads, then replan (the drain bumps their
                # label epochs, invalidating the plan just computed)
                for view in need_drain:
                    self.sess.refresh(view.name)
                    self.stats.drains += 1
                plan, base = self._plan_for(t)
            t.hoisted = bool(scopes)
            ans = self._memo_answer(t, plan, base)
            if ans is not None:
                resolved.append((t, ans[0], ans[1]))
                continue
            window.append((t, plan, base))
        return window, resolved, embeds

    def _embed_blocked(self, t: ServeTicket,
                       scopes: List[FenceScope]) -> bool:
        """May a queued fence ahead change what this embedding read returns?
        Conservative per-view scoping: the fence names the backing view's
        materialized label (exact maintenance rewrites it), or names the
        view in ``deferred_views`` (applying it queues deltas the embedder's
        refresh would then observe)."""
        emb = self._embedders.get(t.embed)
        view = self.sess.views.get(emb.view_name) if emb else None
        if view is None:
            return False               # dropped view: fail fast at execution
        return any(sc.global_ or view.label_id in sc.edge_labels
                   or view.name in sc.deferred_views for sc in scopes)

    def _run_embeds(self, embeds: List[ServeTicket]) -> None:
        """Answer eligible embedding reads, one table refresh per embedder.

        Runs *instead of* a query window within this step: a refresh may
        drain the backing view (bumping its label epoch), so read plans are
        recomputed by the next ``_collect`` rather than executed stale."""
        refreshed: Dict[str, bool] = {}
        for t in embeds:
            emb = self._embedders[t.embed]
            if t.embed not in refreshed:
                refreshed[t.embed] = emb.refresh()
                if refreshed[t.embed]:
                    self.stats.embed_refreshes += 1
            t.embed_result = EmbedResult(
                node_ids=t.node_ids, embeddings=emb.lookup(t.node_ids),
                view=emb.view_name, version=emb.version)
            t.window = self.epoch
            t.window_seq = self._window_seq
            t.via = "embed"
            self.stats.embed_reads += 1
            if t.hoisted:
                self.stats.hoisted += 1

    def _freshness_gate(self, plan: CompiledPlan, scopes: List[FenceScope]):
        """Classify a read against the stale views its plan touches.

        Returns ``(blocked, need_drain)``.  A read whose plan expands a
        non-exact view's label must order behind every queued fence that
        impacts the view (sequential-twin parity: those fences' deltas
        belong to the read's snapshot), unless the view is bounded-stale and
        the read provably stays within the declared bound even if every
        impacting fence ahead applied first — then it may hoist and answer
        stale.  Once no impacting fence is ahead, a read touching an
        over-bound or deferred stale view drains it before running."""
        sess = self.sess
        blocked = False
        need_drain: List = []
        for view in sess.views.values():
            if view.label_id not in plan.label_epochs:
                continue
            ahead = [sc for sc in scopes if view.name in sc.deferred_views]
            pol = view.vdef.refresh
            if pol.mode == "bounded_stale":
                pend = view.pending
                cur_age = (0 if pend.is_empty
                           else sess.write_epoch - pend.first_epoch)
                # conservative future-staleness estimate: every impacting
                # fence ahead applies first, each contributing all its ops
                est = max(pend.writes + sum(sc.write_ops for sc in ahead),
                          cur_age + len(ahead))
                if est <= pol.staleness:
                    continue          # stale answer permitted: hoistable
            if ahead:
                blocked = True
                break
            if sess._read_triggers_drain(view):
                need_drain.append(view)
        return blocked, need_drain

    def step(self) -> bool:
        """Advance the scheduler by one action: answer memo-servable
        tickets, execute one batch window, or apply the front write fence.
        Returns False when the queue is drained."""
        if not self._queue:
            return False
        window, resolved, embeds = self._collect()
        for t, rr, via in resolved:
            self._finish_read(t, rr, via)
        if embeds:
            self._run_embeds(embeds)
        elif window:
            window.sort(key=lambda e: (e[0].admit_by, e[0].uid))
            selected = window[:self.window_limit]
            self._run_window(selected)
        elif not resolved:
            if self._queue[0].kind != "write":
                # unreachable: the front read has no fences ahead of it, so
                # it is always eligible or memo-servable
                raise RuntimeError("serve scheduler stalled with a pending "
                                   f"read at the queue front "
                                   f"(uid={self._queue[0].uid})")
            self._apply_fence(self._queue.popleft())
        self._queue = collections.deque(
            t for t in self._queue if not t.done)
        if self.selector is not None:
            # quiescent point: the window ran (or the fence applied) and no
            # in-flight plan references exist — catalog churn here honors
            # the single-writer contract, and the next _collect re-plans
            if self.selector.maybe_evaluate():
                self.stats.auto_creates = self.selector.stats.creates
                self.stats.auto_drops = self.selector.stats.drops
        return True

    def run(self) -> ServeStats:
        """Drain the queue synchronously.  Returns cumulative stats."""
        while self.step():
            pass
        return self.stats

    async def drain(self) -> ServeStats:
        """Async drain: yields to the event loop between scheduler steps so
        coroutines awaiting tickets observe completions as they happen."""
        import asyncio
        while self.step():
            await asyncio.sleep(0)
        return self.stats

    def poll(self, t: ServeTicket) -> bool:
        """Non-blocking completion check (pure — does not advance)."""
        return t.done

    def result(self, t: ServeTicket):
        """Pump the scheduler until ``t`` completes; returns its result."""
        while not t.done:
            if not self.step():
                raise RuntimeError(
                    f"ticket {t.uid} cannot complete: queue drained")
        if t.kind == "read":
            return t.result
        if t.kind == "embed":
            return t.embed_result
        return t.write_result

    # -------------------------------------------------------------- window

    def _finish_read(self, t: ServeTicket, rr: RowResult, via: str) -> None:
        t.result = rr.to_reach_result()
        t.window = self.epoch
        t.window_seq = self._window_seq
        t.via = via
        if self.selector is not None and t.query is not None:
            self.selector.observe_read(t.query, t.result.metrics.db_hits)
        st = self.stats
        st.queries += 1
        if via == "memo":
            st.memo_hits += 1
        elif via == "gather":
            st.gathers += 1
        if t.hoisted:
            st.hoisted += 1

    def _run_window(self, selected) -> None:
        """Execute one batch window against the current engine snapshot."""
        sess = self.sess
        st = self.stats
        cfg = self.cfg
        g_before = sess.g
        t0 = time.perf_counter()

        groups: Dict[int, _Group] = {}
        for t, plan, base in selected:
            grp = groups.get(id(plan))
            if grp is None:
                grp = groups[id(plan)] = _Group(plan, base)
            grp.tickets.append(t)
            key = None if t.sources is None else t.sources.tobytes()
            idx = grp.spec_idx.get(key)
            if idx is None:
                idx = len(grp.spec_sources)
                grp.spec_idx[key] = idx
                grp.spec_sources.append(
                    plan.default_sources() if t.sources is None
                    else t.sources)
                if key is None:
                    grp.unbound_idx = idx
            grp.ticket_spec.append(idx)

        # split each group's specs into executed bindings and bindings
        # answered by gathering rows of the group's unbound execution
        plan_exec: Dict[int, List[int]] = {}      # group -> exec spec idxs
        plan_gather: Dict[int, List[int]] = {}    # group -> gathered idxs
        for gid, grp in groups.items():
            ex, ga = [], []
            ub = grp.unbound_idx
            ub_src = grp.spec_sources[ub] if ub is not None else None
            for i, src in enumerate(grp.spec_sources):
                if (ub is not None and i != ub
                        and _subset(src, ub_src)):
                    ga.append(i)
                else:
                    ex.append(i)
            plan_exec[gid] = ex
            plan_gather[gid] = ga

        # bucket groups by structure for cross-fingerprint sharing
        buckets: Dict[tuple, List[int]] = {}
        singles: List[int] = []
        if cfg.structural_sharing:
            if sess.view_set_generation != self._bucket_pool_gen:
                # view-churn invalidation: drop warm shape keys learned
                # under an older catalog so dropped-view shapes stop riding
                # the pool and the pool can't grow without bound under churn
                self._bucket_pool.clear()
                self._bucket_pool_gen = sess.view_set_generation
            for gid, grp in groups.items():
                skey = grp.plan.structure_key()
                if skey is None:
                    singles.append(gid)
                else:
                    bkey = (skey, grp.plan.share_scales())
                    buckets.setdefault(bkey, []).append(gid)
            for bkey, gids in list(buckets.items()):
                if len(gids) < 2 and bkey not in self._bucket_pool:
                    singles.extend(gids)
                    del buckets[bkey]
                else:
                    self._bucket_pool.add(bkey)
        else:
            singles = list(groups)

        spec_results: Dict[int, List[Optional[RowResult]]] = {
            gid: [None] * len(groups[gid].spec_sources) for gid in groups}

        def account(n_rows: int) -> None:
            sizes = block_sizes(n_rows, sess.cfg.src_block,
                                cfg.adaptive_blocks)
            st.rows += n_rows
            st.blocks += len(sizes)
            st.block_capacity += sum(sizes)
            st.block_sizes.extend(sizes)

        for gid in singles:
            grp = groups[gid]
            ex = plan_exec[gid]
            srcs = [grp.spec_sources[i] for i in ex]
            rrs = grp.plan.execute_rows(srcs,
                                        adaptive_blocks=cfg.adaptive_blocks)
            for i, rr in zip(ex, rrs):
                spec_results[gid][i] = rr
            account(sum(int(np.asarray(s).shape[0]) for s in srcs))

        for (skey, _), gids in buckets.items():
            plans = [groups[gid].plan for gid in gids]
            spec_lists = [[groups[gid].spec_sources[i]
                           for i in plan_exec[gid]] for gid in gids]
            shared = sess.planner.shared_program(skey)
            per_plan = shared.execute(plans, spec_lists,
                                      adaptive_blocks=cfg.adaptive_blocks)
            if len(gids) == 1:
                st.warm_pool_hits += 1
            for gid, rrs in zip(gids, per_plan):
                for i, rr in zip(plan_exec[gid], rrs):
                    spec_results[gid][i] = rr
                st.shared_groups += 1
            account(sum(int(np.asarray(s).shape[0])
                        for specs in spec_lists for s in specs))

        for gid, grp in groups.items():
            ub = grp.unbound_idx
            for i in plan_gather[gid]:
                spec_results[gid][i] = spec_results[gid][ub].gather(
                    grp.spec_sources[i])
            # memoize every binding's rows for cross-window reuse
            if cfg.reuse_results:
                for key, i in grp.spec_idx.items():
                    self._memo[(grp.base, key)] = (grp.plan,
                                                   spec_results[gid][i])
            reach = [rr.to_reach_result() for rr in spec_results[gid]]
            seen_specs = set()
            for t, i in zip(grp.tickets, grp.ticket_spec):
                t.result = reach[i]
                t.window = self.epoch
                t.window_seq = self._window_seq
                if self.selector is not None and t.query is not None:
                    self.selector.observe_read(t.query,
                                               t.result.metrics.db_hits)
                if i in plan_gather[gid]:
                    t.via = "gather"
                    st.gathers += 1
                elif i in seen_specs:
                    t.via = "dedup"
                else:
                    t.via = "exec"
                seen_specs.add(i)
                if t.window_seq > t.admit_by:
                    st.deadline_misses += 1
                if t.hoisted:
                    st.hoisted += 1
            st.groups += 1
            st.queries += len(grp.tickets)
            st.executions += len(plan_exec[gid])
            st.group_sizes.append(len(grp.tickets))

        # reads are pure: the window ran against one engine snapshot
        assert sess.g is g_before, "a read mutated the session graph"
        st.windows += 1
        st.window_sizes.append(len(selected))
        self._window_seq += 1

        # adaptive window limit: back off when per-ticket latency spikes,
        # grow with queue depth (more waiting tickets -> bigger batches)
        elapsed = time.perf_counter() - t0
        per_ticket = elapsed / max(len(selected), 1)
        depth = sum(1 for t in self._queue
                    if t.kind == "read" and not t.done)
        if (self._lat_ewma is not None
                and per_ticket > cfg.latency_backoff * self._lat_ewma
                and self.window_limit > cfg.window_min):
            self.window_limit = max(cfg.window_min, self.window_limit // 2)
        elif depth > self.window_limit:
            self.window_limit = min(cfg.window_max, self.window_limit * 2)
        a = cfg.latency_smoothing
        self._lat_ewma = (per_ticket if self._lat_ewma is None
                          else a * per_ticket + (1 - a) * self._lat_ewma)

    # --------------------------------------------------------------- fence

    def _apply_fence(self, t: ServeTicket) -> None:
        t.write_result = self.sess.apply_writes(t.batch)
        t.window = self.epoch
        self.epoch += 1
        if self.selector is not None and t.scope is not None:
            self.selector.observe_write(max(t.scope.write_ops, 1))
        self.stats.write_batches += 1
        self._pending_dead.difference_update(
            int(e) for e in t.batch.edge_deletes)
        self._pending_dead_nodes.difference_update(
            int(n) for n in t.batch.node_deletes)
        self._evict_memo(t.scope)

    # ----------------------------------------------- session notifications

    def _on_view_drained(self, view) -> None:
        """A view's materialized edges just changed outside any fence scope
        (queued deltas replayed): drop memo entries whose plan reads them.
        Plan identity would miss anyway (the drain bumps the view label's
        epoch), but eviction keeps the memo from pinning dead row blocks."""
        self._evict_view_label(view.label_id)

    def _on_view_dropped(self, view) -> None:
        self._evict_view_label(view.label_id)

    def _evict_view_label(self, label_id: int) -> None:
        if not self._memo:
            return
        dead = [key for key, (plan, _) in self._memo.items()
                if label_id in plan.label_epochs]
        for key in dead:
            del self._memo[key]

    def _evict_memo(self, scope: FenceScope) -> None:
        """Drop memo entries the fence may invalidate.  Label staleness is
        doubly covered (plan-identity check at lookup), but node-prop writes
        and node creates don't bump label epochs — scope eviction is the
        mechanism that keeps those exact."""
        if not self._memo:
            return
        if scope.global_:
            self._memo.clear()
            return
        dead = [key for key, (plan, _) in self._memo.items()
                if self._conflicts(plan, key[1] is None, scope)]
        for key in dead:
            del self._memo[key]


def _subset(sub: np.ndarray, sorted_arr: Optional[np.ndarray]) -> bool:
    """Is every id of ``sub`` present in ``sorted_arr`` (ascending)?"""
    if sorted_arr is None:
        return False
    sub = np.asarray(sub)
    if sub.shape[0] == 0:
        return True
    if sorted_arr.shape[0] == 0:
        return False
    idx = np.clip(np.searchsorted(sorted_arr, sub), 0,
                  sorted_arr.shape[0] - 1)
    return bool(np.all(sorted_arr[idx] == sub))

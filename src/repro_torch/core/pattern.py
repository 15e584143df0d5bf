"""Pattern-graph IR for Cypher/GQL path patterns.

Mirrors the paper's Figure 5 grammar: a pattern element is an alternating
sequence ``NodePat (RelPat NodePat)*``; a relationship may carry a hop range
``*n..m`` where ``m`` can be unbounded (``INF_HOPS``).  The IR also carries the
``isReferenced`` flag the paper's ``NodeCanMatch``/``RelpCanMatch`` checks use
(§V-B): interior elements of a matched path may only be spliced out if no other
clause references them.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

from repro_torch.utils import INF_HOPS


class Direction(enum.Enum):
    OUT = ">"   # (a)-[r]->(b)
    IN = "<"    # (a)<-[r]-(b)
    BOTH = "-"  # (a)-[r]-(b)

    def reversed(self) -> "Direction":
        if self is Direction.OUT:
            return Direction.IN
        if self is Direction.IN:
            return Direction.OUT
        return Direction.BOTH


# ---------------------------------------------------------------------------
# Property predicates
# ---------------------------------------------------------------------------

PRED_OPS = ("=", "<", "<=", ">", ">=")


def _cmp(vals, op: str, value: int):
    """Elementwise predicate comparison — the single comparator every layer
    shares: host scalars (`PropPred.holds`), numpy masks (maintenance), and
    torch tensor masks on any device (executor/plans) all route through it."""
    if op == "=":
        return vals == value
    if op == "<":
        return vals < value
    if op == "<=":
        return vals <= value
    if op == ">":
        return vals > value
    if op == ">=":
        return vals >= value
    raise ValueError(f"unknown predicate op {op!r}; supported: {PRED_OPS}")


@dataclass(frozen=True, order=True)
class PropPred:
    """One atomic property comparison ``prop op value`` (integer domain).

    A pattern element carries a *conjunction* of these (its ``preds`` tuple).
    On a variable-length relationship the predicate applies to **every** edge
    of the traversed walk (the per-hop edge mask is predicate-filtered).
    """

    prop: str
    op: str            # one of PRED_OPS
    value: int

    def pretty(self) -> str:
        return f"{self.prop} {self.op} {self.value}"

    def holds(self, v: int) -> bool:
        return bool(_cmp(v, self.op, self.value))


def _pred_intervals(preds: Tuple[PropPred, ...]) -> "dict[str, Tuple[int, int]]":
    """Conjunction -> per-prop closed interval [lo, hi] over the int domain.

    ``None`` bounds are represented by +-inf sentinels so interval algebra is
    plain integer comparison.  An unsatisfiable conjunction yields an empty
    interval (lo > hi)."""
    INF = 1 << 62
    out: dict = {}
    for p in preds:
        lo, hi = out.get(p.prop, (-INF, INF))
        if p.op == "=":
            lo, hi = max(lo, p.value), min(hi, p.value)
        elif p.op == ">":
            lo = max(lo, p.value + 1)
        elif p.op == ">=":
            lo = max(lo, p.value)
        elif p.op == "<":
            hi = min(hi, p.value - 1)
        else:  # <=
            hi = min(hi, p.value)
        out[p.prop] = (lo, hi)
    return out


def normalize_preds(preds: Tuple[PropPred, ...]) -> Tuple[PropPred, ...]:
    """Canonical form of a predicate conjunction.

    Per prop the conjunction collapses to one closed interval: a point becomes
    a single ``=`` atom, finite bounds become ``>=``/``<=`` atoms, and an
    unsatisfiable conjunction becomes the fixed pair ``>= 1, <= 0``.  Two
    conjunctions with the same satisfying set normalize identically, so the
    normalized tuple is a sound cache/fingerprint key and equality test."""
    if not preds:
        return ()
    INF = 1 << 62
    out: List[PropPred] = []
    iv = _pred_intervals(preds)
    for prop in sorted(iv):
        lo, hi = iv[prop]
        if lo > hi:
            out += [PropPred(prop, ">=", 1), PropPred(prop, "<=", 0)]
        elif lo == hi:
            out.append(PropPred(prop, "=", lo))
        else:
            if lo > -INF:
                out.append(PropPred(prop, ">=", lo))
            if hi < INF:
                out.append(PropPred(prop, "<=", hi))
    return tuple(out)


def preds_imply(stronger: Tuple[PropPred, ...],
                weaker: Tuple[PropPred, ...]) -> bool:
    """True iff every assignment satisfying ``stronger`` satisfies ``weaker``
    (region containment; the matcher's subsumption test).  Vacuously true when
    ``weaker`` is empty; an unsatisfiable ``stronger`` implies anything."""
    a = _pred_intervals(stronger)
    b = _pred_intervals(weaker)
    if any(lo > hi for lo, hi in a.values()):
        return True
    for prop, (blo, bhi) in b.items():
        if prop not in a:
            return False
        alo, ahi = a[prop]
        if alo < blo or ahi > bhi:
            return False
    return True


@dataclass(frozen=True)
class NodePat:
    var: Optional[str] = None
    label: Optional[str] = None
    key: Optional[int] = None          # {<pk>: key} filter ($K:$V)
    is_referenced: bool = False        # referenced outside the MATCH path?
    preds: Tuple[PropPred, ...] = ()   # property predicate conjunction

    def pretty(self) -> str:
        s = self.var or ""
        if self.label:
            s += f":{self.label}"
        items = ([f"id: {self.key}"] if self.key is not None else []) \
            + [p.pretty() for p in self.preds]
        if items:
            s += "{" + ", ".join(items) + "}"
        return f"({s})"


@dataclass(frozen=True)
class RelPat:
    var: Optional[str] = None
    label: Optional[str] = None
    direction: Direction = Direction.OUT
    min_hops: int = 1
    max_hops: int = 1                  # INF_HOPS for unbounded
    is_referenced: bool = False
    preds: Tuple[PropPred, ...] = ()   # applies to every edge of the walk

    @property
    def is_varlen(self) -> bool:
        return not (self.min_hops == 1 and self.max_hops == 1)

    @property
    def unbounded(self) -> bool:
        return self.max_hops == INF_HOPS

    def hop_range(self) -> Tuple[int, int]:
        return self.min_hops, self.max_hops

    def pretty(self) -> str:
        inner = self.var or ""
        if self.label:
            inner += f":{self.label}"
        if self.is_varlen:
            hi = "" if self.unbounded else str(self.max_hops)
            inner += f"*{self.min_hops}..{hi}"
        if self.preds:
            inner += "{" + ", ".join(p.pretty() for p in self.preds) + "}"
        body = f"[{inner}]"
        if self.direction is Direction.OUT:
            return f"-{body}->"
        if self.direction is Direction.IN:
            return f"<-{body}-"
        return f"-{body}-"


@dataclass(frozen=True)
class PathPattern:
    """Alternating [NodePat, RelPat, NodePat, ...]; len(nodes) == len(rels)+1."""

    nodes: Tuple[NodePat, ...]
    rels: Tuple[RelPat, ...]

    def __post_init__(self):
        if len(self.nodes) != len(self.rels) + 1:
            raise ValueError("path must alternate node/rel/node")

    @property
    def start(self) -> NodePat:
        return self.nodes[0]

    @property
    def end(self) -> NodePat:
        return self.nodes[-1]

    def var_names(self) -> List[str]:
        out = [n.var for n in self.nodes if n.var]
        out += [r.var for r in self.rels if r.var]
        return out

    def pretty(self) -> str:
        s = self.nodes[0].pretty()
        for r, n in zip(self.rels, self.nodes[1:]):
            s += r.pretty() + n.pretty()
        return s

    def reversed(self) -> "PathPattern":
        return PathPattern(
            nodes=tuple(reversed(self.nodes)),
            rels=tuple(replace(r, direction=r.direction.reversed())
                       for r in reversed(self.rels)),
        )


@dataclass(frozen=True)
class Query:
    """A parsed MATCH ... RETURN query (single path pattern, per the paper)."""

    path: PathPattern
    returns: Tuple[str, ...] = ()
    limit: Optional[int] = None
    count_only: bool = False           # RETURN count(*)
    force_bool: bool = False           # preserve set semantics after rewrite

    def pretty(self) -> str:
        ret = "count(*)" if self.count_only else ", ".join(self.returns)
        return f"MATCH {self.path.pretty()} RETURN {ret}"


@dataclass(frozen=True)
class FreshnessPolicy:
    """Per-view refresh policy (``CREATE VIEW ... REFRESH <mode>``).

    ``exact``         — synchronous delta maintenance inside every write
                        (the paper's model; the default).
    ``deferred``      — writes enqueue coalesced per-(view, label) deltas;
                        the queue drains on the first read that could use
                        the view, or when the serve engine applies a fence
                        whose readers depend on it.
    ``bounded_stale`` — like deferred, but reads within the staleness bound
                        may answer from the stale view; the queue drains
                        lazily once queued-write count or epoch age exceeds
                        ``staleness``.
    """

    mode: str = "exact"        # "exact" | "deferred" | "bounded_stale"
    staleness: int = 0         # bound for bounded_stale (writes or epochs)

    def __post_init__(self):
        if self.mode not in ("exact", "deferred", "bounded_stale"):
            raise ValueError(f"unknown freshness mode {self.mode!r}")
        if self.mode == "bounded_stale" and self.staleness < 1:
            raise ValueError("bounded_stale requires staleness >= 1")

    @property
    def is_exact(self) -> bool:
        return self.mode == "exact"

    def pretty(self) -> str:
        if self.mode == "exact":
            return "REFRESH EXACT"
        if self.mode == "deferred":
            return "REFRESH DEFERRED"
        return f"REFRESH STALENESS {self.staleness}"


@dataclass(frozen=True)
class ViewDef:
    """CREATE VIEW <name> AS (CONSTRUCT (s)-[:name]->(d) MATCH <path>)."""

    name: str
    src_var: str
    dst_var: str
    match: PathPattern
    refresh: FreshnessPolicy = FreshnessPolicy()

    def __post_init__(self):
        vars_ = {self.match.start.var, self.match.end.var}
        if self.src_var not in vars_ or self.dst_var not in vars_:
            raise ValueError(
                "CONSTRUCT endpoints must be the MATCH path endpoints "
                f"(got {self.src_var}->{self.dst_var} over {vars_})"
            )

    @property
    def forward(self) -> bool:
        """True if the view edge runs start->end of the match path."""
        return self.src_var == self.match.start.var

    def pretty(self) -> str:
        suffix = "" if self.refresh.is_exact else f" {self.refresh.pretty()}"
        return (
            f"CREATE VIEW {self.name} AS (CONSTRUCT ({self.src_var})-"
            f"[r:{self.name}]->({self.dst_var}) MATCH {self.match.pretty()})"
            f"{suffix}"
        )


def mark_references(path: PathPattern, referenced: set[str]) -> PathPattern:
    """Set ``is_referenced`` on pattern elements whose var appears elsewhere."""
    nodes = tuple(
        replace(n, is_referenced=(n.var is not None and n.var in referenced))
        for n in path.nodes
    )
    rels = tuple(
        replace(r, is_referenced=(r.var is not None and r.var in referenced))
        for r in path.rels
    )
    return PathPattern(nodes=nodes, rels=rels)


@dataclass(frozen=True)
class QueryFingerprint:
    """Canonical, hashable identity of a query's *execution-relevant* shape.

    Produced by :func:`repro_torch.core.parser.canonicalize_query`: variable names
    are erased (only their ``is_referenced`` consequences survive) and label
    strings are resolved to schema label ids, so two textually different
    queries that compile to the same physical work share one fingerprint.
    Label ids are stable for the schema's lifetime; a label that is unknown
    at fingerprint time resolves to ``NEVER_LABEL`` and re-resolves to its
    real id the moment it is interned — the fingerprint is recomputed per
    call, so plan-cache keys are always resolution-current.

    ``RETURN`` lists, ``LIMIT`` and ``count_only`` enter the fingerprint only
    through the ``is_referenced`` flags they induce (which gate the view
    matcher's splice legality); beyond that, projection does not change the
    reachability computation (:class:`~repro_torch.core.executor.ReachResult`
    carries the full per-source rows either way), so e.g. ``RETURN n, m`` and
    ``RETURN count(*)`` over paths with the same referenced set share a plan.
    """

    nodes: Tuple[Tuple[int, Optional[int], Tuple[PropPred, ...], bool], ...]
    # per node: (label_id, key, normalized preds, is_referenced)
    rels: Tuple[Tuple[int, str, int, int, Tuple[PropPred, ...], bool], ...]
    # per rel: (label_id, direction value, min_hops, max_hops,
    #           normalized preds, is_referenced)
    force_bool: bool = False


@dataclass
class ViewEdgePat:
    """Marker rel used after ChangePG: a rel whose label names a view."""

    view_name: str

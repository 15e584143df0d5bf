"""Cypher/GQL-subset parser for MATCH queries and CREATE VIEW statements.

Covers the grammar of the paper's Figure 5 plus the MATCH/RETURN form used in
its examples:

    MATCH (n:Comment)-[r:replyOf*..]->(m:Post) RETURN n, m
    MATCH (n:Person {id: 5})-[:knows*1..3]->(m) RETURN count(*)
    CREATE VIEW ROOT_POST AS (
        CONSTRUCT (c)-[r:ROOT_POST]->(p)
        MATCH (c:Comment)-[:replyOf*..]->(p:Post))

Hop ranges: ``*`` = 1..inf, ``*n`` = n..n, ``*n..`` = n..inf, ``*..m`` = 1..m,
``*n..m``.

Property filters: a ``{k: v}`` map on a node or relationship adds equality
predicates — the reserved name ``id`` on a node addresses the primary key
(the paper's ``$L{$K:$V}`` templates), every other name an integer property
column.  A ``WHERE`` clause after the path adds comparison predicates
(``WHERE n.age > 30 AND r.w <= 5``) on the named pattern elements; ops are
``=, <, <=, >, >=`` and conjunction only (matching the predicate IR).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from repro_torch.core.pattern import (
    Direction, FreshnessPolicy, NodePat, PathPattern, PRED_OPS, PropPred,
    Query, QueryFingerprint, RelPat, ViewDef, mark_references,
    normalize_preds,
)
from repro_torch.utils import INF_HOPS

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<arrow_r>->)
  | (?P<arrow_l><-)
  | (?P<dots>\.\.)
  | (?P<cmp><=|>=|<|>)
  | (?P<punct>[()\[\]{}:,*\-=.])
    """,
    re.VERBOSE,
)

_KEYWORDS = {"MATCH", "RETURN", "CREATE", "VIEW", "AS", "CONSTRUCT", "WHERE",
             "LIMIT", "COUNT", "AND", "REFRESH", "EXACT", "DEFERRED",
             "STALENESS"}


class ParseError(ValueError):
    pass


def _tokenize(text: str) -> List[str]:
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ParseError(f"unexpected character {text[pos]!r} at {pos}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        toks.append(m.group())
    return toks


def _tok_equal(t: str, expected: str) -> bool:
    """Keyword tokens compare case-insensitively (``match`` parses like
    ``MATCH``, per Cypher); everything else — labels, variables,
    punctuation — compares case-sensitively."""
    if expected.upper() in _KEYWORDS:
        return t.upper() == expected.upper()
    return t == expected


class _Cursor:
    def __init__(self, toks: List[str]):
        self.toks = toks
        self.i = 0

    def peek(self, k: int = 0) -> Optional[str]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise ParseError("unexpected end of input")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, tok: str) -> str:
        t = self.next()
        if not _tok_equal(t, tok):
            raise ParseError(f"expected {tok!r}, got {t!r} at token {self.i - 1}")
        return t

    def accept(self, tok: str) -> bool:
        t = self.peek()
        if t is None:
            return False
        ok = _tok_equal(t, tok)
        if ok:
            self.i += 1
        return ok

    def done(self) -> bool:
        return self.i >= len(self.toks)


def _parse_props(c: _Cursor, pk_name: Optional[str] = "id"
                 ) -> Tuple[Optional[int], Tuple[PropPred, ...]]:
    """``{ name : int, ... }`` -> (primary-key value, predicates).

    On nodes the reserved prop name ``id`` (the paper's ``$K``) addresses the
    primary-key column; every other ``name : int`` entry becomes an equality
    predicate on a property column.  Relationships have no primary key
    (``pk_name=None``), so every entry is a predicate there.  A comparison
    entry ``name op int`` (ops ``=, <, <=, >, >=``) adds the corresponding
    predicate — the form :meth:`NodePat.pretty` emits, so predicate patterns
    round-trip through the parser.
    """
    if not c.accept("{"):
        return None, ()
    key: Optional[int] = None
    preds: List[PropPred] = []
    while True:
        name = c.next()
        if c.accept(":"):
            op = None           # plain map entry ('=', pk-aware)
        else:
            op = c.next()
            if op not in PRED_OPS:
                raise ParseError(f"expected ':' or comparison op in "
                                 f"{PRED_OPS}, got {op!r}")
        val = c.next()
        if not val.isdigit():
            raise ParseError(f"only integer property values supported, "
                             f"got {val!r}")
        if pk_name is not None and name == pk_name:
            # the primary key is a dedicated column, not a property: a
            # comparison other than equality cannot be expressed as a key
            # filter and would otherwise silently probe a zero-filled
            # property column named 'id'
            if op not in (None, "="):
                raise ParseError(
                    f"{pk_name!r} is the primary key; only equality "
                    f"({pk_name}: v) is supported, got {op!r}")
            key = int(val)
        else:
            preds.append(PropPred(prop=name, op=op or "=", value=int(val)))
        if not c.accept(","):
            break
    c.expect("}")
    return key, tuple(preds)


def _parse_node(c: _Cursor) -> NodePat:
    c.expect("(")
    var = None
    label = None
    t = c.peek()
    if t not in (":", ")", "{") and t is not None:
        var = c.next()
    if c.accept(":"):
        label = c.next()
    key, preds = _parse_props(c)
    c.expect(")")
    return NodePat(var=var, label=label, key=key, preds=preds)


def _parse_hops(c: _Cursor) -> Tuple[int, int]:
    """After ``*``: optional ``n``, optional ``..``, optional ``m``."""
    lo, hi = 1, INF_HOPS
    t = c.peek()
    if t is not None and t.isdigit():
        lo = int(c.next())
        hi = lo  # '*n' alone means exactly n
    if c.accept(".."):
        hi = INF_HOPS
        t = c.peek()
        if t is not None and t.isdigit():
            hi = int(c.next())
    if hi != INF_HOPS and hi < lo:
        raise ParseError(f"hop range {lo}..{hi} is empty")
    return lo, hi


def _parse_rel(c: _Cursor) -> RelPat:
    """Parses ``-[...]->`` / ``<-[...]-`` / ``-[...]-``."""
    t = c.next()
    if t == "<-":
        left = True
    elif t == "-":
        left = False
    else:
        raise ParseError(f"expected relationship, got {t!r}")
    var = None
    label = None
    lo, hi = 1, 1
    preds: Tuple[PropPred, ...] = ()
    if c.accept("["):
        t = c.peek()
        if t not in (":", "]", "*", "{") and t is not None:
            var = c.next()
        if c.accept(":"):
            label = c.next()
        if c.accept("*"):
            lo, hi = _parse_hops(c)
        # rel props are honored as edge predicates (rels have no primary key);
        # on a variable-length rel the predicate applies to every hop edge
        _, preds = _parse_props(c, pk_name=None)
        c.expect("]")
    t = c.next()
    if left:
        if t != "-":
            raise ParseError(f"expected '-' after <-[...], got {t!r}")
        direction = Direction.IN
    elif t == "->":
        direction = Direction.OUT
    elif t == "-":
        direction = Direction.BOTH
    else:
        raise ParseError(f"expected '->' or '-', got {t!r}")
    return RelPat(var=var, label=label, direction=direction,
                  min_hops=lo, max_hops=hi, preds=preds)


def _parse_path(c: _Cursor) -> PathPattern:
    nodes = [_parse_node(c)]
    rels: List[RelPat] = []
    while c.peek() in ("-", "<-"):
        rels.append(_parse_rel(c))
        nodes.append(_parse_node(c))
    return PathPattern(nodes=tuple(nodes), rels=tuple(rels))


def _parse_where(c: _Cursor, path: PathPattern) -> PathPattern:
    """``WHERE v.prop op int (AND ...)*`` — attach predicates to the named
    pattern elements.  The var reference does not mark the element as
    referenced: the predicate becomes part of the element's own constraints
    (it survives rewrites the way labels do), not a projection of it."""
    from dataclasses import replace as _replace
    by_var: Dict[str, List[PropPred]] = {}
    while True:
        var = c.next()
        c.expect(".")
        prop = c.next()
        op = c.next()
        if op not in PRED_OPS:
            raise ParseError(f"expected comparison op in {PRED_OPS}, "
                             f"got {op!r}")
        val = c.next()
        if not val.isdigit():
            raise ParseError(f"only integer predicate values supported, "
                             f"got {val!r}")
        by_var.setdefault(var, []).append(PropPred(prop, op, int(val)))
        if not c.accept("AND"):
            break
    known = {n.var for n in path.nodes if n.var} \
        | {r.var for r in path.rels if r.var}
    unknown = set(by_var) - known
    if unknown:
        raise ParseError(f"WHERE references unknown vars {sorted(unknown)}; "
                         f"pattern vars: {sorted(known)}")

    def attach_node(n: NodePat) -> NodePat:
        key = n.key
        keep: List[PropPred] = []
        for p in by_var.get(n.var, ()):
            if p.prop == "id":
                # 'id' names the primary-key column, never a property —
                # WHERE n.id = v must behave exactly like {id: v}
                if p.op != "=":
                    raise ParseError(
                        "'id' is the primary key; only equality "
                        "(n.id = v) is supported in WHERE")
                key = p.value
            else:
                keep.append(p)
        return _replace(n, key=key, preds=n.preds + tuple(keep))

    nodes = tuple(attach_node(n) if n.var in by_var else n
                  for n in path.nodes)
    rels = tuple(
        _replace(r, preds=r.preds + tuple(by_var.get(r.var, ())))
        if r.var in by_var else r for r in path.rels)
    return PathPattern(nodes=nodes, rels=rels)


def parse_query(text: str) -> Query:
    """Parse ``MATCH <path> [WHERE ...] RETURN ...`` into a :class:`Query`."""
    c = _Cursor(_tokenize(text))
    c.expect("MATCH")
    path = _parse_path(c)
    if c.accept("WHERE"):
        path = _parse_where(c, path)
    returns: List[str] = []
    count_only = False
    limit = None
    if c.accept("RETURN"):
        if c.accept("COUNT"):
            c.expect("(")
            c.expect("*")
            c.expect(")")
            count_only = True
        else:
            returns.append(c.next())
            while c.accept(","):
                returns.append(c.next())
    if c.accept("LIMIT"):
        limit = int(c.next())
    if not c.done():
        raise ParseError(f"trailing tokens: {c.toks[c.i:]}")
    path = mark_references(path, set(returns))
    return Query(path=path, returns=tuple(returns), limit=limit,
                 count_only=count_only)


def query_fingerprint(q: Query, schema) -> QueryFingerprint:
    """Label-id-resolving fingerprint of ``q`` (no allocation beyond tuples).

    The plan cache's hot-path key: var names are simply omitted (only their
    ``is_referenced`` consequences matter to the matcher), and label strings
    resolve through ``schema`` to dense ids (wildcards to ``NO_LABEL``,
    not-yet-interned labels to ``NEVER_LABEL``).  Resolution is recomputed on
    every call, so fingerprints stay current as labels are interned.
    """
    path = q.path
    return QueryFingerprint(
        nodes=tuple((schema.node_label_id(n.label), n.key,
                     normalize_preds(n.preds), n.is_referenced)
                    for n in path.nodes),
        rels=tuple((schema.edge_label_id(r.label), r.direction.value,
                    r.min_hops, r.max_hops, normalize_preds(r.preds),
                    r.is_referenced)
                   for r in path.rels),
        force_bool=q.force_bool,
    )


def canonicalize_query(q: Query, schema) -> "tuple[Query, QueryFingerprint]":
    """Canonicalization pass: stable var renaming + label-id resolution.

    Returns ``(canonical query, fingerprint)``.  The canonical query renames
    every node var to ``n<i>`` and every rel var to ``r<i>`` (positionally),
    preserving the ``is_referenced`` flags the matcher consults — so var
    spelling never splits the plan cache.  Callers that only need the cache
    key should use :func:`query_fingerprint` directly (the planner's warm
    path does): it skips rebuilding the pattern dataclasses.
    """
    from dataclasses import replace as _replace
    path = q.path
    nodes = tuple(
        _replace(n, var=None if n.var is None else f"n{i}")
        for i, n in enumerate(path.nodes))
    rels = tuple(
        _replace(r, var=None if r.var is None else f"r{i}")
        for i, r in enumerate(path.rels))
    canon = _replace(q, path=PathPattern(nodes=nodes, rels=rels))
    return canon, query_fingerprint(q, schema)


def parse_view(text: str) -> ViewDef:
    """Parse a CREATE VIEW statement (paper §IV-A, Figure 5)."""
    c = _Cursor(_tokenize(text))
    c.expect("CREATE")
    c.expect("VIEW")
    name = c.next()
    c.expect("AS")
    c.expect("(")
    c.expect("CONSTRUCT")
    cpath = _parse_path(c)
    if len(cpath.rels) != 1:
        raise ParseError("CONSTRUCT must be (s)-[r:VIEW]->(d)")
    rel = cpath.rels[0]
    if rel.label != name:
        raise ParseError(
            f"view edge label {rel.label!r} must equal the view name {name!r}")
    if rel.direction is not Direction.OUT:
        raise ParseError("CONSTRUCT edge must be directed ->")
    c.expect("MATCH")
    mpath = _parse_path(c)
    if c.accept("WHERE"):
        mpath = _parse_where(c, mpath)
    c.expect(")")
    refresh = FreshnessPolicy()
    if c.accept("REFRESH"):
        if c.accept("EXACT"):
            refresh = FreshnessPolicy(mode="exact")
        elif c.accept("DEFERRED"):
            refresh = FreshnessPolicy(mode="deferred")
        elif c.accept("STALENESS"):
            tok = c.next()
            try:
                bound = int(tok)
            except ValueError:
                raise ParseError(
                    f"REFRESH STALENESS expects an integer bound, got {tok!r}")
            refresh = FreshnessPolicy(mode="bounded_stale", staleness=bound)
        else:
            raise ParseError(
                "REFRESH expects EXACT, DEFERRED, or STALENESS <n> "
                f"(got {c.peek()!r})")
    if not c.done():
        raise ParseError(f"trailing tokens: {c.toks[c.i:]}")
    src_var, dst_var = cpath.nodes[0].var, cpath.nodes[1].var
    if src_var is None or dst_var is None:
        raise ParseError("CONSTRUCT endpoints must be named variables")
    return ViewDef(name=name, src_var=src_var, dst_var=dst_var, match=mpath,
                   refresh=refresh)

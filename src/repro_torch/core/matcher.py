"""MatchView (Algorithm 4): match a view's pattern path into a query path.

The paper's matcher is VF2-style over general pattern graphs; since both the
view pattern and our query patterns are *paths* (the paper's Figure 5 grammar
only produces paths), matching reduces to aligned subpath comparison — the
same NodeCanMatch / RelpCanMatch predicates (label equality, direction,
min/max hops, isReferenced, interior degree-2) applied over a sliding window,
in both orientations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.pattern import (
    NodePat, PathPattern, RelPat, normalize_preds, preds_imply,
)


@dataclass(frozen=True)
class ViewMatch:
    start: int        # index of the first matched query node
    length: int       # number of matched rels (== len(view.match.rels))
    forward: bool     # True if query subpath aligns with the view path order


def _node_can_match(qn: NodePat, vn: NodePat, interior: bool) -> bool:
    """Paper's NodeCanMatch plus predicate subsumption.

    Labels must be equal.  Interior nodes must be unreferenced and degree-2
    (degree-2 is structural in a path; a key filter would be an extra
    constraint the view does not preserve, so interior keys forbid) and their
    predicates must be *equivalent* to the view's — the spliced view edge
    erases the interior node, so no residual filter can reconcile a
    difference in either direction.

    Endpoints survive the splice, so the query's predicates stay on the
    rewritten path as a residual filter; the match is legal iff the query
    endpoint's region is *contained* in the view endpoint's
    (``view_pred ⊇ query_pred``) — the view stores every row the stricter
    query needs.  Incomparable or wider query predicates: no match."""
    if qn.label != vn.label:
        return False
    if interior:
        if qn.is_referenced or qn.key is not None:
            return False
        if normalize_preds(qn.preds) != normalize_preds(vn.preds):
            return False
    else:
        # the view only covers sources satisfying ITS endpoint constraints:
        if vn.key is not None and qn.key != vn.key:
            return False
        if not preds_imply(normalize_preds(qn.preds),
                           normalize_preds(vn.preds)):
            return False
    return True


def _rel_can_match(qr: RelPat, vr: RelPat) -> bool:
    """Paper's RelpCanMatch: label, direction, min-hop, max-hop all equal and
    the query rel must not be referenced elsewhere.  The rel disappears into
    the view edge, so — like interior nodes — its predicates must be
    equivalent to the view's, not merely comparable."""
    return (qr.label == vr.label
            and qr.direction == vr.direction
            and qr.min_hops == vr.min_hops
            and qr.max_hops == vr.max_hops
            and normalize_preds(qr.preds) == normalize_preds(vr.preds)
            and not qr.is_referenced)


def _try_at(qpath: PathPattern, vpath: PathPattern, start: int) -> bool:
    k = len(vpath.rels)
    for j in range(k + 1):
        interior = 0 < j < k
        if not _node_can_match(qpath.nodes[start + j], vpath.nodes[j], interior):
            return False
    for j in range(k):
        if not _rel_can_match(qpath.rels[start + j], vpath.rels[j]):
            return False
    return True


def match_view(qpath: PathPattern, vpath: PathPattern) -> Optional[ViewMatch]:
    """First match of ``vpath`` (either orientation) inside ``qpath``."""
    k = len(vpath.rels)
    if k == 0 or k > len(qpath.rels):
        return None
    rpath = vpath.reversed()
    for start in range(len(qpath.rels) - k + 1):
        if _try_at(qpath, vpath, start):
            return ViewMatch(start=start, length=k, forward=True)
        if _try_at(qpath, rpath, start):
            return ViewMatch(start=start, length=k, forward=False)
    return None


def read_may_use_view(qpath: PathPattern, view_name: str,
                      vpath: PathPattern, splice: bool = True) -> bool:
    """Freshness gate (DESIGN.md §11): could evaluating ``qpath`` read the
    edges of the view named ``view_name`` — directly, because the query
    pattern names the view label, or indirectly, because the optimizer could
    splice the view into the plan?  Conservative in the cheap direction: a
    True here only costs an eager drain, never a stale answer."""
    if any(r.label == view_name for r in qpath.rels):
        return True
    return splice and match_view(qpath, vpath) is not None

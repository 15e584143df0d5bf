"""View-based query optimizer (Algorithm 3).

Views are sorted by the paper's optimization-effect estimate (Eq. 1-2,
maintained in :class:`ViewStats`), then greedily matched into the query path
and spliced (ChangePG) until no view matches.  The rewrite preserves the
original query's result semantics: queries that originally contained an
unbounded variable-length edge ran under set semantics, so the rewritten
(now bounded) query carries ``force_bool``.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Iterable, List, Sequence

from repro_torch.core.matcher import ViewMatch, match_view
from repro_torch.core.pattern import Direction, PathPattern, Query, RelPat


def sort_by_opt_eff(views: Sequence) -> List:
    """SortByOptEff: descending ViewOptEff (Eq. 1 with the Eq. 2 estimate)."""
    return sorted(views, key=lambda v: v.stats.opt_eff(), reverse=True)


def change_pg(qpath: PathPattern, m: ViewMatch, view) -> PathPattern:
    """ChangePG: replace the matched span with a single view edge."""
    # view edges physically run match-start -> match-end when vdef.forward;
    # the spliced rel direction encodes both that and the match orientation.
    out_dir = Direction.OUT if (m.forward == view.vdef.forward) else Direction.IN
    vrel = RelPat(var=None, label=view.name, direction=out_dir,
                  min_hops=1, max_hops=1)
    nodes = (qpath.nodes[: m.start + 1]
             + qpath.nodes[m.start + m.length:])
    rels = (qpath.rels[: m.start] + (vrel,)
            + qpath.rels[m.start + m.length:])
    return PathPattern(nodes=nodes, rels=rels)


def optimize_query(q: Query, views: Iterable) -> Query:
    """Algorithm 3: iterate views in ViewOptEff order; match+splice to fixpoint."""
    views = sort_by_opt_eff(list(views))
    path = q.path
    had_unbounded = any(r.unbounded for r in path.rels)
    budget = (len(path.rels) + 1) * (len(views) + 1) + 8  # termination guard
    for view in views:
        while budget > 0:
            m = match_view(path, view.vdef.match)
            if m is None:
                break
            path = change_pg(path, m, view)
            budget -= 1
    return replace(q, path=path,
                   force_bool=q.force_bool or had_unbounded)

"""The port's spans under its fences, for the readers of an unbounded
view's maintenance.

A fence is one ``maint.apply`` root (``GraphSession.apply_writes``); a
view's maintenance is a ``maint.view`` span under it, whose ``unbounded``
attr is 1 where the view's match has an unbounded hop range; an unbounded
fixpoint is an ``exec.closure`` span (``iters`` its hops, ``pulls`` its
flag reads).  A program whose ``maint.view`` spans carry no ``unbounded``
attr gives nothing to read, as one without the tracer does."""
from __future__ import annotations

from typing import List, Optional, Tuple


def under_fences() -> Optional[Tuple[list, int, List[bool]]]:
    """The finished spans under ``maint.apply`` roots (the roots
    included), the number of roots, and for each span whether an
    ``exec.closure`` span encloses it.  None when the record holds no
    fence, or its ``maint.view`` spans carry no ``unbounded`` attr."""
    try:
        from repro_torch.utils import trace
    except ImportError:
        return None
    recs = trace.spans()
    root_of, in_closure = [], []
    for r in recs:
        up = r.parent
        root_of.append(r.index if up is None else root_of[up])
        in_closure.append(up is not None and (
            recs[up].name == "exec.closure" or in_closure[up]))
    keep = [i for i, r in enumerate(recs)
            if recs[root_of[i]].name == "maint.apply"
            and r.end_ns is not None]
    got = [recs[i] for i in keep]
    if not any(r.name == "maint.view" and "unbounded" in r.attrs
               for r in got):
        return None
    n_roots = sum(r.parent is None for r in got)
    return got, n_roots, [in_closure[i] for i in keep]

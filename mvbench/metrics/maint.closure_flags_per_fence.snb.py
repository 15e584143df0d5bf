"""Convergence flags a fence's unbounded fixpoints read off the card: the
``pulls`` of the port's ``exec.closure`` spans under its ``maint.apply``
spans over the number of those roots, in the traced pass
(``mvbench/fence_spans.py``).  Each flag read is one host sync."""
from mvbench.fence_spans import under_fences


def read(ctx):
    got = under_fences()
    if got is None:
        return None
    recs, n_roots, _ = got
    return sum(r.attrs.get("pulls", 0) for r in recs
               if r.name == "exec.closure") / n_roots

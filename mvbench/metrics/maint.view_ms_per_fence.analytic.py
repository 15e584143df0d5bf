"""Milliseconds a fence spends maintaining its views: the port's
``maint.view`` spans (one a view and fence, the view's delta or recompute
pass) over the number of ``maint.apply`` spans, in the traced pass
(``mvbench/spans.py``).  The rest of a fence is the write itself, the
engine's bookkeeping and the property pass."""
from mvbench.spans import totals


def read(ctx):
    t = totals("maint.apply")
    if t is None or "maint.view" not in t:
        return None
    return 1e3 * t["maint.view"]["s"] / t["maint.apply"]["n"]

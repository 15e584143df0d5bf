"""Milliseconds a fence spends in ``GraphSession.apply_writes``: the mean
of the port's ``maint.apply`` spans in the traced pass
(``mvbench/spans.py``)."""
from mvbench.spans import totals


def read(ctx):
    t = totals("maint.apply")
    if t is None:
        return None
    a = t["maint.apply"]
    return 1e3 * a["s"] / a["n"]

"""Milliseconds a fence spends maintaining views whose match has an
unbounded hop range (SNB's ``ROOT_POST``, ``replyOf*..``): the port's
``maint.view`` spans with ``unbounded`` 1 over the number of
``maint.apply`` spans, in the traced pass (``mvbench/fence_spans.py``)."""
from mvbench.fence_spans import under_fences


def read(ctx):
    got = under_fences()
    if got is None:
        return None
    recs, n_roots, _ = got
    return 1e3 * sum(r.seconds for r in recs if r.name == "maint.view"
                     and r.attrs["unbounded"] == 1) / n_roots

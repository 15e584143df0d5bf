"""Page-locked blocks the pinned-host pool had to create for the reads'
batch pulls, per read: the ``pinned_new`` counts of the port's ``exec.pull``
spans under its ``session.query`` spans, over those roots, in the traced
pass (``mvbench/spans.py``).  0 where every read's rows landed in a cached
block.  Nothing where no pull landed in page-locked memory: no CUDA device,
or a program that pulls into pageable memory."""
from mvbench.spans import totals


def read(ctx):
    t = totals("session.query")
    if t is None or "pinned_new" not in t.get("exec.pull", {}):
        return None
    return t["exec.pull"]["pinned_new"] / t["session.query"]["n"]

"""Share of the fences' time spent in unbounded fixpoints: the port's
outermost ``exec.closure`` spans under its ``maint.apply`` spans over
those roots, in percent, in the traced pass
(``mvbench/fence_spans.py``)."""
from mvbench.fence_spans import under_fences


def read(ctx):
    got = under_fences()
    if got is None:
        return None
    recs, _, enclosed = got
    fences = sum(r.seconds for r in recs if r.parent is None)
    if fences <= 0:
        return None
    return 100.0 * sum(r.seconds for r, inner in zip(recs, enclosed)
                       if r.name == "exec.closure" and not inner) / fences

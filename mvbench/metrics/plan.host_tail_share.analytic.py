"""Share of a read's wall time that the host spends after the last device
op the read launched (building the result from the pulled rows), summed
over the reads of the traced pass, in percent (``mvbench/trace.py``)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    tails = [(wall, tail) for _, wall, tail in tr["span_tails"]]
    if not tails:
        return None
    return 100.0 * sum(t for _, t in tails) / sum(w for w, _ in tails)

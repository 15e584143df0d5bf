"""Share of the reads' pulled rows that came off at one byte an entry, in
percent: the ``byte_rows`` counts of the port's ``exec.pull`` spans under
its ``session.query`` spans, over their ``rows`` counts, in the traced pass
(``mvbench/spans.py``).  Nothing where no pull counts its rows: a program
that does not count them, or a pass that pulled none."""
from mvbench.spans import totals


def read(ctx):
    t = totals("session.query")
    pull = (t or {}).get("exec.pull", {})
    if not pull.get("rows"):
        return None
    return 100.0 * pull.get("byte_rows", 0) / pull["rows"]

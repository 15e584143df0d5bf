"""Share of the reads' time spent turning pulled rows into results, in
percent: the port's ``exec.result`` spans (the int32 copy of the rows, the
per-query row slices and the folding into ``ReachResult``) over its
``session.query`` spans, in the traced pass (``mvbench/spans.py``)."""
from mvbench.spans import read_share


def read(ctx):
    return read_share("exec.result")

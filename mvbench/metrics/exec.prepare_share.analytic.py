"""Share of the reads' time spent preparing a plan's execution, in percent:
the port's ``exec.prepare`` spans (the default sources, padding, node data
and the operand caches, with their rebuilds after a write) over its
``session.query`` spans, in the traced pass (``mvbench/spans.py``)."""
from mvbench.spans import read_share


def read(ctx):
    return read_share("exec.prepare")

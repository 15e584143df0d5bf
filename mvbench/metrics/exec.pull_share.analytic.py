"""Share of the reads' time spent in the batch pull, in percent: the port's
``exec.pull`` spans (the one ``host()`` call of ``_run_blocks``, which
copies the rows and metrics to the host once the blocks have run) over its
``session.query`` spans, in the traced pass (``mvbench/spans.py``)."""
from mvbench.spans import read_share


def read(ctx):
    return read_share("exec.pull")

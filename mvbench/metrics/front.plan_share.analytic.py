"""Share of the reads' time spent planning, in percent: the port's
``front.plan`` spans (fingerprint, the view rewrite, the plan cache and the
replan after a drain, ``GraphSession.query``) over its ``session.query``
spans, in the traced pass (``mvbench/spans.py``)."""
from mvbench.spans import read_share


def read(ctx):
    return read_share("front.plan")

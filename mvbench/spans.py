"""The port's own spans (``repro_torch.utils.trace``), summed for the
per-layer readers.

The port records its spans in memory while a profiler records, on the
profiler's clock, and adds nothing to the profiler's trace.  A traced run
profiles the window's first pass, so the record the readers find after the
run is that pass's.  A program without the tracer gives nothing to read,
and the readers then report nothing."""
from __future__ import annotations

from typing import Dict, Optional


def totals(root: str) -> Optional[Dict[str, dict]]:
    """Per span name, over every span under a root span named ``root``
    (the roots included): ``n`` spans, ``s`` seconds, and each numeric
    attr summed.  None when the record holds no such root."""
    try:
        from repro_torch.utils import trace
    except ImportError:
        return None
    recs = trace.spans()
    root_of = []
    out: Dict[str, dict] = {}
    for r in recs:
        root_of.append(r.index if r.parent is None else root_of[r.parent])
        if recs[root_of[-1]].name != root or r.end_ns is None:
            continue
        t = out.setdefault(r.name, {"n": 0, "s": 0.0})
        t["n"] += 1
        t["s"] += r.seconds
        for k, v in r.attrs.items():
            if isinstance(v, (int, float)):
                t[k] = t.get(k, 0) + v
    return out if root in out else None


def read_share(name: str) -> Optional[float]:
    """Seconds in the spans ``name`` over seconds in the reads (the
    ``session.query`` roots), in percent."""
    t = totals("session.query")
    if t is None or name not in t or t["session.query"]["s"] <= 0:
        return None
    return 100.0 * t[name]["s"] / t["session.query"]["s"]

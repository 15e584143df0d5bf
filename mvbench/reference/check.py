"""The comparison that decides ``correct``.

The harness hands over the generated arrays, its log of what the window
did in submission order (each fence's ops, and each read with the
program's answer where it is judged), and the pairs every view stored
at the end.  The reference replays the fences on its own
:class:`~mvbench.reference.paths.GraphState`, evaluates each sampled read
where it stands in the log, and derives every view from the final graph.
Every number it returns is compared with the limit 0.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from mvbench.reference.paths import Evaluator, GraphState, is_counting


def _same_row(got, want_cols, want_vals) -> bool:
    cols, vals = got
    return (np.array_equal(np.asarray(cols, np.int64), want_cols)
            and np.array_equal(np.asarray(vals, np.int64), want_vals))


def check(data: dict, reads: List[dict], views: List[dict], oplog: list,
          stored: Dict[str, tuple], device) -> dict:
    """``reads``/``views``: the configuration's entries (each with
    ``path``); ``oplog``: ``("write", ops)`` and ``("read", i, answer)``
    with ``answer`` None for reads not judged, else
    ``{"src_ids": ids, "rows": {src: (cols, vals)}}`` (sampled rows) or
    ``{"src_ids": ids, "full": reach}`` (every row); ``stored``: view
    name -> (src, dst, count) arrays the program stored.  Also returns
    each view's pair count as derived here (``view_pairs``)."""
    state = GraphState.from_data(data)
    ev = Evaluator(state, device)
    out = {"rows_wrong": 0, "sources_wrong": 0, "view_pairs_wrong": 0,
           "rows_compared": 0, "reads_compared": 0, "view_pairs": {}}
    pending: Dict[int, list] = {}

    def flush():
        for i, rows in pending.items():
            srcs = np.asarray([s for s, _ in rows], np.int64)
            k = 0
            for _, R in ev.rows(reads[i]["path"], srcs):
                R = R.cpu().numpy()
                for r in range(R.shape[0]):
                    cols = np.flatnonzero(R[r])
                    if not _same_row(rows[k][1], cols, R[r, cols]):
                        out["rows_wrong"] += 1
                    out["rows_compared"] += 1
                    k += 1
        pending.clear()

    def full_rows(path, want, full):
        """Every row of an unbound read, against the reference's rows for
        the sources it should have had."""
        n = state.n_nodes
        if full.shape[0] != want.shape[0]:
            out["rows_wrong"] += max(full.shape[0], want.shape[0])
            out["rows_compared"] += max(full.shape[0], want.shape[0])
            return
        b0 = 0
        for _, R in ev.rows(path, want):
            R = R.cpu().numpy()
            got = full[b0:b0 + R.shape[0]]
            bad = (got[:, :n] != R).any(axis=1) | (got[:, n:] != 0).any(axis=1)
            out["rows_wrong"] += int(bad.sum())
            out["rows_compared"] += R.shape[0]
            b0 += R.shape[0]

    for entry in oplog:
        if entry[0] == "write":
            flush()
            state.apply(entry[1])
            continue
        _, i, answer = entry
        if answer is None:
            continue
        out["reads_compared"] += 1
        want = state.alive_nodes(reads[i]["path"]["start"])
        if not np.array_equal(np.asarray(answer["src_ids"], np.int64), want):
            out["sources_wrong"] += 1
        if "full" in answer:
            full_rows(reads[i]["path"], want, answer["full"])
        else:
            pending.setdefault(i, []).extend(sorted(answer["rows"].items()))
    flush()

    for v in views:
        path = v["path"]
        s, d, c = ev.pairs(path, state.alive_nodes(path["start"]))
        if not is_counting(path):
            c = np.ones_like(c)
        want = dict(zip(zip(s.tolist(), d.tolist()), c.tolist()))
        out["view_pairs"][v["name"]] = len(want)
        gs, gd, gc = stored[v["name"]]
        got = dict(zip(zip(np.asarray(gs).tolist(), np.asarray(gd).tolist()),
                       np.asarray(gc).tolist()))
        out["view_pairs_wrong"] += sum(
            1 for k in want.keys() | got.keys() if want.get(k) != got.get(k))
    return out

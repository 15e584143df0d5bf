"""The paper's analytic workload as one closed-loop client.

A pass takes one write cycle's CE, DE and DV (``mvbench/writes.py``)
through ``GraphSession.apply_writes``, then every read of the
configuration over all its sources (unbound), with views, through
``GraphSession.query``, then
the four recover fences, so each pass ends on the graph it started from
and its reads see the writes (the paper's driver ran its writes after the
reads; here a write the program drops shows in the rows). One pass warms
up in set-up. The window holds whole passes: it starts at the first
statement of a pass and ends with the pass running when ``--seconds`` have
passed; ``reads_per_s`` is every read of those passes over that time.

Each read's source ids are kept for the check; every row of the window's
first pass, and in later passes the rows of ``check_rows`` sources drawn
from the seed and of every node the pass's writes touched. A traced run
profiles the window's first pass.
"""
from __future__ import annotations

import time

import numpy as np

from mvbench.harness import seed_rng
from mvbench.probes import HopRecorder, counters
from mvbench.trace import Capture, span
from mvbench.writes import WriteTargets


def run(h) -> None:
    t = h.traffic
    sess, state = h.sess, h.state
    targets = WriteTargets(state, seed_rng(h.seed, "writes"))
    rng = seed_rng(h.seed, "sample")
    k_rows = int(t["check_rows"])

    # host seconds of the window spent in the writes and in each read
    spent = np.zeros(1 + len(h.queries))

    def fence(f) -> None:
        h.oplog.append(("write", f.ops))
        t = time.perf_counter()
        with span(f"write:{f.kind}"):
            h.applied(f, sess.apply_writes(h.batch_of(f)))
        spent[0] += time.perf_counter() - t

    def one_pass(judge) -> None:
        cyc = targets.cycle()
        for take in (cyc.ce_write, cyc.de_write, cyc.dv_write):
            fence(take())
        s, d, _ = state.edge(cyc.e)
        touched = np.asarray([s, d, cyc.n] + [
            x for hh in cyc.killed for x in state.edge(hh)[:2]], np.int64)
        for i, q in enumerate(h.queries):
            t = time.perf_counter()
            with span(f"read:Q{i + 1}"):
                res = sess.query(q, use_views=True)
            spent[1 + i] += time.perf_counter() - t
            ans = None
            if judge == "full":
                ans = {"src_ids": np.asarray(res.src_ids), "full": res.reach}
            elif judge:
                ids = np.asarray(res.src_ids)
                pick = rng.choice(ids, size=min(k_rows, ids.shape[0]),
                                  replace=False)
                ans = h.answer(res, np.union1d(pick, touched))
            h.oplog.append(("read", i, ans))
            del res
        for take in (cyc.ce_recover, cyc.de_recover, cyc.dv_recover_node,
                     cyc.dv_recover_edges):
            fence(take())

    one_pass(judge=None)
    h.sync()
    h.e2e["setup_s"] = time.perf_counter() - h.t0
    h.mark_peak("warm_up")
    spent[:] = 0
    c0 = counters()
    t0 = time.perf_counter()
    passes = 0
    ends = []
    while True:
        if h.trace and passes == 0:
            cap = Capture()
            with HopRecorder(sess) as rec, cap:
                one_pass(judge="full")
            h.layer["hops"] = rec.launches
            h.layer["nnz_of"] = {lab: int(state.edges_of(lab).shape[0])
                                 for lab in state.edge_labels}
        else:
            one_pass(judge="full" if passes == 0 else "sample")
        passes += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= h.seconds:
            break
    h.sync()
    window = time.perf_counter() - t0
    c1 = counters()
    n_reads = passes * len(h.queries)
    h.e2e["reads_per_s"] = n_reads / window
    h.attempted = n_reads
    h.layer.update(reads=n_reads, pulls=c1["pulls"] - c0["pulls"],
                   spmm_launches=c1["spmm_launches"] - c0["spmm_launches"])
    h.diag.update(passes=passes, window_s=window,
                  pass_s=list(np.diff([0.0] + ends)),
                  writes_s=float(spent[0]), read_s=spent[1:].tolist())
    if h.trace:
        h.trace_summary = cap.summary(
            kernel_groups={"block_spmm": ("spmm_", "to_u8_kernel")})

"""The port's spans (``repro_torch.utils.trace``): on exactly while a
profiler records, in memory, on the profiler's clock, and read by the
benchmark's per-layer readers.

A read is one ``session.query`` root whose children are the plan, the
preparation, the pull and the result; a fence is one
``maint.apply`` root with one ``maint.view`` a maintained view.  The
``pulls`` the spans count add up to the port's own pull counters, and
nothing changes with tracing off: results and counters are the same, and a
span costs a flag test.
"""
import ast
import itertools
import time
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch.core as P
from repro_torch.utils import host, host_flag, trace

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
READ_CHILDREN = {"front.plan", "exec.prepare", "exec.pull", "exec.result"}
VIEWS = ("CREATE VIEW V AS (CONSTRUCT (s)-[r:V]->(d) "
         "MATCH (s:A)-[:x*1..2]->(d:A))",
         "CREATE VIEW W AS (CONSTRUCT (s)-[r:W]->(d) "
         "MATCH (s:A)-[:x]->(m:B)-[:x]->(d))")
READS = ("MATCH (s:A)-[:x*1..]->(d) RETURN s, d",
         "MATCH (s:A)-[:x]->(m:B)-[:x]->(d) RETURN s, d")


def session(device="cpu"):
    """Chains a-b-a-b... of 2 to 9 nodes with skip edges, two views."""
    schema = P.GraphSchema()
    b = P.GraphBuilder(schema)
    nid = 0
    for length in (2, 3, 5, 9):
        for i in range(length):
            b.add_node("A" if i % 2 == 0 else "B")
        for i in range(length - 1):
            b.add_edge(nid + i, nid + i + 1, "x")
            if i + 2 < length:
                b.add_edge(nid + i, nid + i + 2, "x")
        nid += length
    sess = P.GraphSession(b.finalize(edge_cap=256, device=device), schema,
                          device=device)
    for v in VIEWS:
        sess.create_view(v)
    return sess


def pulls() -> int:
    return host.calls + host_flag.calls


def traced(fn):
    """``fn()`` under a profiler: (its result, the record, pulls made)."""
    p0 = pulls()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, trace.spans(), pulls() - p0


def write(sess):
    """A fence: one edge created between two chains, then deleted."""
    b = P.WriteBatch()
    b.create_edge(0, 2, "x")
    slot = int(np.asarray(sess.apply_writes(b).edge_slots)[0])
    return slot


def children(recs, root):
    return [r for r in recs if r.parent == root.index]


def test_off_adds_no_span_and_changes_no_result():
    """With no profiler a read and a fence add nothing to the record, and
    the read's rows and pulls are the traced read's."""
    assert not torch.autograd.profiler._is_profiler_enabled
    sess = session()
    before = trace.spans()
    sess.delete_edge(write(sess))
    sess.query(READS[0], use_views=True)                   # warm the caches
    p0 = pulls()
    off = sess.query(READS[0], use_views=True)
    off_pulls = pulls() - p0
    assert trace.spans() == before
    on, _, on_pulls = traced(lambda: sess.query(READS[0], use_views=True))
    assert on_pulls == off_pulls > 0
    np.testing.assert_array_equal(on.reach, off.reach)
    assert (on.metrics.db_hits, on.metrics.rows) == \
        (off.metrics.db_hits, off.metrics.rows)


@pytest.mark.parametrize("q", READS)
def test_a_read_is_one_root_with_its_stages(q):
    sess = session()
    misses = sess.planner.plan_misses
    _, recs, n_pulls = traced(lambda: sess.query(q, use_views=True))
    assert sess.planner.plan_misses == misses + 1   # a fresh plan, traced
    (root,) = [r for r in recs if r.parent is None]
    assert root.name == "session.query"
    kids = children(recs, root)
    # an unbounded hop range runs its closure between preparation and pull
    closure = {"exec.closure"} if "*1.." in q else set()
    assert {r.name for r in kids} == READ_CHILDREN | closure
    assert len(kids) == len(recs) - 1          # every span is a child
    assert {r.request for r in recs} == {root.request}
    for r in kids:
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
    assert sum(r.end_ns - r.start_ns for r in kids) <= \
        root.end_ns - root.start_ns
    (pull,) = [r for r in kids if r.name == "exec.pull"]
    assert "bytes" not in pull.attrs           # no copy off a host tensor
    assert "pinned_new" not in pull.attrs      # nor into page-locked memory
    # the pulls by span add up to the port's own counters over the read
    assert sum(r.attrs.get("pulls", 0) for r in recs) == n_pulls


@pytest.mark.cuda
def test_a_card_reads_pull_counts_the_pinned_blocks_it_made():
    """On a card the pull span carries ``pinned_new``: the blocks the pinned
    pool created for the rows, none for a read of the same shape once the
    first one's result is gone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sess = session("cuda")
    sess.query(READS[0], use_views=True)                   # warm the caches
    _, recs, _ = traced(lambda: sess.query(READS[0], use_views=True))
    (pull,) = [r for r in recs if r.name == "exec.pull"]
    assert pull.attrs["pinned_new"] >= 0 and pull.attrs["bytes"] > 0
    sess.query(READS[0], use_views=True)            # untraced: ends a stretch
    _, recs, _ = traced(lambda: sess.query(READS[0], use_views=True))
    (pull,) = [r for r in recs if r.name == "exec.pull"]
    assert pull.attrs["pinned_new"] == 0


def reader(name):
    from mvbench import harness
    return harness.plugin("metrics", name, ROOT, ["mvbench"])


def test_pinned_new_reader_reads_nothing_without_card_spans():
    """``exec.pinned_new_per_read.analytic`` reads None over a host read's
    spans, and the blocks over the reads where the pulls carry them."""
    read = reader("exec.pinned_new_per_read.analytic").read
    sess = session()
    traced(lambda: sess.query(READS[1], use_views=True))
    assert read({}) is None

    def reads(news):
        for n in news:
            with trace.span("session.query"):
                with trace.span("exec.pull"):
                    trace.add("pinned_new", n)
    for news, want in (([1, 0, 2, 0], 0.75), ([0, 0], 0)):
        with trace.span("untraced"):              # ends the last stretch
            pass
        traced(lambda: reads(news))
        assert read({}) == want


def test_a_fence_is_one_root_with_a_span_a_view():
    sess = session()
    _, recs, n_pulls = traced(lambda: write(sess))
    (root,) = [r for r in recs if r.parent is None]
    assert root.name == "maint.apply"
    views = [r for r in recs if r.name == "maint.view"]
    assert sorted(r.attrs["view"] for r in views) == ["V", "W"]
    assert all(r.parent == root.index and r.request == root.request
               for r in views)
    assert sum(r.attrs.get("pulls", 0) for r in recs) == n_pulls > 0


def test_a_new_profile_drops_the_last_ones_spans():
    sess = session()
    _, first, _ = traced(lambda: sess.query(READS[1], use_views=True))
    sess.query(READS[1], use_views=True)            # untraced: ends a stretch
    _, second, _ = traced(lambda: sess.query(READS[1], use_views=True))
    assert [r.name for r in second if r.parent is None] == ["session.query"]
    assert second[0].start_ns > first[0].end_ns
    assert not {id(r) for r in first} & {id(r) for r in second}


def test_spans_share_the_profilers_clock():
    """A span's start and a ``record_function`` entered right after it
    bracket that range's raw profiler stamp, within 1 ms."""
    ms = 1_000_000
    probes = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        for i in range(5):
            with trace.span("probe") as rec:
                with record_function(f"probe{i}"):
                    t1 = time.time_ns()
            probes.append((rec, t1))
    t0 = prof.profiler.kineto_results.trace_start_ns()
    raw = {e.name: t0 + round(e.time_range.start * 1000)
           for e in prof.events() if e.name.startswith("probe")}
    offsets = []
    for i, (rec, t1) in enumerate(probes):
        stamp = raw[f"probe{i}"]
        assert rec.start_ns - ms <= stamp <= t1 + ms, (i, stamp - rec.start_ns)
        offsets.append(abs(stamp - rec.start_ns))
    assert min(offsets) < ms


def test_off_costs_a_flag_test(monkeypatch):
    """Off, a span is the one shared do-nothing context: no clock read, no
    record, no wait for a device, and nothing allocated that outlives
    it."""
    def no_clock():
        raise AssertionError("a span read the clock with tracing off")

    def no_wait(*a):
        raise AssertionError("a span waited for the device with tracing off")

    monkeypatch.setattr(trace.time, "time_ns", no_clock)
    monkeypatch.setattr(trace.torch.cuda, "synchronize", no_wait)
    assert trace.span("a") is trace.span("b", view="V") is trace._OFF

    def spin(it):
        for _ in it:
            trace.settle("cuda")
            with trace.span("x"):
                trace.add("pulls", 1)

    spin(itertools.repeat(None, 100))
    it = itertools.repeat(None, 1000)
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        spin(it)
        cur, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert cur == base and peak - base < 512


def test_settle_waits_for_a_card_only_while_traced(monkeypatch):
    """The wait that keeps a read's blocks out of its pull span is made
    only while a profiler records, and only for a CUDA device."""
    waited = []
    monkeypatch.setattr(trace.torch.cuda, "synchronize", waited.append)
    trace.settle("cuda:0")
    with profile(activities=[ProfilerActivity.CPU]):
        trace.settle("cpu")
        trace.settle("cuda:0")
    assert waited == ["cuda:0"]


PROFILER_CALLS = {"record_function", "RecordFunction", "_record_function_enter",
                  "_record_function_enter_new", "emit_nvtx", "range_push"}


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_the_port_adds_nothing_to_the_profilers_trace(path):
    """The benchmark counts every device-typed profiler event as device
    work, and the profiler mirrors annotations onto the device: the port
    names no profiler annotation."""
    for node in ast.walk(ast.parse(path.read_text())):
        name = (node.attr if isinstance(node, ast.Attribute) else
                node.id if isinstance(node, ast.Name) else None)
        assert name not in PROFILER_CALLS, \
            f"{path.relative_to(ROOT)}:{node.lineno} calls {name}"


@pytest.mark.parametrize("name", ["fin-analytic-dense", "snb-analytic"])
def test_readers_on_the_tiny_cells(tmp_path, name):
    """The seven readers over a traced run of each cell at a hundredth of
    its size on the CPU: shares in [0, 100], times positive, no device
    rate without a CUDA device."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "mvbench_tests_conftest", ROOT / "mvbench" / "tests" / "conftest.py")
    conftest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conftest)
    from mvbench import harness
    cell = harness.load_cell(name, conftest.shrink(tmp_path))
    out = harness.run_cell(cell, 2 ** 31 + 23, 1.0, True, "cpu")
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    shares = ["front.plan_share.analytic", "exec.prepare_share.analytic",
              "exec.pull_share.analytic", "exec.result_share.analytic"]
    for k in shares:
        assert 0 <= got[k] <= 100, (k, got[k])
    assert sum(got[k] for k in shares) <= 100
    assert 0 < got["maint.view_ms_per_fence.analytic"] <= \
        got["maint.ms_per_fence.analytic"]
    assert "exec.dtoh_gbps.analytic" not in got
    assert "exec.pinned_new_per_read.analytic" not in got


UNBOUNDED_READERS = ("maint.unbounded_view_ms_per_fence.snb",
                     "maint.closure_share.snb",
                     "maint.closure_flags_per_fence.snb")


def fences(spec):
    """Record fences by hand: each a list of ``(view, unbounded, closures)``
    with ``closures`` a list of ``(pulls, nested pulls or None)``; then set
    every span's times: a fence 10 ms, a view 4 ms, a closure 1 ms, a
    nested one 0.5 ms, fences 20 ms apart."""
    with trace.span("untraced"):                  # ends the last stretch
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        for views in spec:
            with trace.span("maint.apply"):
                for name, unb, closures in views:
                    attrs = {"view": name}
                    if unb is not None:
                        attrs["unbounded"] = unb
                    with trace.span("maint.view", **attrs):
                        for pulls, inner in closures:
                            with trace.span("exec.closure", iters=0):
                                trace.add("pulls", pulls)
                                if inner is not None:
                                    with trace.span("exec.closure", iters=0):
                                        trace.add("pulls", inner)
        with trace.span("session.query"):         # a read: not a fence
            with trace.span("exec.closure", iters=0):
                trace.add("pulls", 100)
    recs = trace.spans()
    ms = {"maint.apply": 10, "maint.view": 4, "session.query": 10}
    t = 0
    for r in recs:
        if r.parent is None:
            t += 20_000_000
        nested = r.parent is not None and recs[r.parent].name == "exec.closure"
        dur = (0.5 if nested else 1) if r.name == "exec.closure" \
            else ms[r.name]
        r.start_ns, r.end_ns = t, t + int(dur * 1e6)


def test_unbounded_view_readers_by_hand():
    """The three readers of an unbounded view's maintenance over fences
    recorded by hand; nothing where the views carry no ``unbounded``."""
    read = {n: reader(n).read for n in UNBOUNDED_READERS}
    fences([[("ROOT_POST", 1, [(3, None), (2, 4)]), ("KNOWS2", 0, [])],
            [("ROOT_POST", 1, []), ("COMMENT_TAG", 0, [(5, None)])]])
    got = {n: f({}) for n, f in read.items()}
    assert got["maint.unbounded_view_ms_per_fence.snb"] == \
        pytest.approx(4.0)                        # 2 x 4 ms over 2 fences
    # outermost closures 3 x 1 ms over 20 ms of fences; the read's is out
    assert got["maint.closure_share.snb"] == pytest.approx(15.0)
    assert got["maint.closure_flags_per_fence.snb"] == \
        pytest.approx((3 + 2 + 4 + 5) / 2)
    fences([[("ROOT_POST", None, [(3, None)])]])  # a program without it
    assert all(f({}) is None for f in read.values())
    traced(lambda: session().query(READS[0], use_views=True))   # no fence
    assert all(f({}) is None for f in read.values())


def test_unbounded_view_readers_on_the_tiny_snb_cell(tmp_path):
    """The three readers over a traced run of the ``snb-analytic`` cell
    at a hundredth of its size on the CPU, as ``BENCHMARK.json`` scores
    them: its first pass's DE and DV keep ``ROOT_POST`` through the
    closure, and every closure reads a flag."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "mvbench_tests_conftest", ROOT / "mvbench" / "tests" / "conftest.py")
    conftest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conftest)
    from mvbench import harness
    cell = harness.load_cell("snb-analytic", conftest.shrink(tmp_path))
    assert set(UNBOUNDED_READERS) <= {m["name"] for m in cell.per_layer}
    out = harness.run_cell(cell, 2 ** 31 + 23, 1.0, True, "cpu")
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    recs = trace.spans()
    root_of = []
    for r in recs:
        root_of.append(r.index if r.parent is None else root_of[r.parent])
    closures = [r for r in recs if r.name == "exec.closure"
                and recs[root_of[r.index]].name == "maint.apply"]
    n_fences = sum(r.name == "maint.apply" for r in recs)
    assert closures and n_fences == 7
    assert got["maint.closure_flags_per_fence.snb"] == pytest.approx(
        sum(r.attrs["pulls"] for r in closures) / n_fences)
    assert got["maint.closure_flags_per_fence.snb"] >= \
        len(closures) / n_fences
    assert 0 < got["maint.closure_share.snb"] < 100
    assert 0 < got["maint.unbounded_view_ms_per_fence.snb"] <= \
        got["maint.view_ms_per_fence.analytic"]

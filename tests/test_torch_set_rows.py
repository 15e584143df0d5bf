"""Set-semantics rows come back one byte an entry.

A read under set semantics (an unbounded hop range, or ``force_bool``)
answers reachability, and its frontier is bool on every route; its rows
come off the device as that bool frontier, ``[S, node_cap]`` and
C-contiguous, equal by value to the reference's int32 rows.  A counting
read's rows stay int32 walk counts.  The unfused executor, the serve
path's shared program and the sharded plans follow the same rule, the
pairs a view is built from keep int32 counts, and the traced pull counts
the rows it pulled and those it pulled at one byte an entry.

The CPU cases hold the port to the reference (a module fixture: the GPU
machine has no JAX, so there only the ``cuda`` cases run); on the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_set_rows.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as P
from repro_torch.serve import ServeConfig
from repro_torch.utils import trace

COUNTING_READ = "MATCH (a:A)-[e:x*1..2]->(d:B) WHERE a.age >= 3 RETURN a, d"
SET_READ = "MATCH (a:A)-[e:x*1..]->(d:B) RETURN a, d"
# a second set-semantics plan of SET_READ's structure, for a shared batch
SET_READ_2 = "MATCH (a:B)-[e:y*1..]->(d:A) WHERE e.w >= 1 RETURN a, d"

ROUTES = {
    "segment": dict(backend="segment", plan_backend="segment"),
    "dense": dict(backend="dense"),
    "dense-kernel": dict(backend="dense", use_kernel=True),
    "shards2": dict(data_shards=2),
}


@pytest.fixture(scope="module")
def R():
    """The JAX reference's package."""
    pytest.importorskip("jax")
    import repro.core
    return repro.core


def build(pkg, cfg=None, seed=0, n=24, device="cpu"):
    rng = np.random.default_rng(seed)
    schema = pkg.GraphSchema()
    b = pkg.GraphBuilder(schema)
    for i in range(n):
        b.add_node(("A", "B")[i % 2], props={"age": int(rng.integers(0, 8))})
    for u in range(n):
        for v in range(n):
            if u != v and rng.random() < 0.15:
                b.add_edge(u, v, ("x", "y")[int(rng.integers(2))],
                           props={"w": int(rng.integers(0, 5))})
    if pkg is not P:
        return pkg.GraphSession(b.finalize(edge_cap=1024), schema)
    return P.GraphSession(b.finalize(edge_cap=1024, device=device), schema,
                          P.ExecConfig(**cfg) if cfg else None, device=device)


def rows_dtype(counting):
    return np.int32 if counting else np.bool_


def pull_span(fn):
    """``fn()`` under a profiler: (its result, its one ``exec.pull`` span)."""
    with trace.span("untraced"):          # found off: ends the last stretch
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    (pull,) = [r for r in trace.spans() if r.name == "exec.pull"]
    return out, pull


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("q", [COUNTING_READ, SET_READ])
def test_rows_are_bool_under_set_semantics_and_int32_when_counting(
        R, q, route):
    ps = build(P, ROUTES[route])
    got, want = ps.query(q), build(R).query(q)
    assert got.counting == (q == COUNTING_READ)
    assert got.reach.dtype == rows_dtype(got.counting)
    assert np.asarray(want.reach).dtype == np.int32
    assert got.reach.flags.c_contiguous
    assert got.reach.shape == (got.src_ids.shape[0], ps.g.node_cap)
    np.testing.assert_array_equal(got.src_ids, np.asarray(want.src_ids))
    np.testing.assert_array_equal(got.reach, np.asarray(want.reach))
    assert got.reach.any()                 # the graph has pairs to find


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_set_pairs_keep_int32_counts_and_the_references_totals(R, route):
    got, want = build(P, ROUTES[route]).query(SET_READ), \
        build(R).query(SET_READ)
    pairs = got.pairs()
    assert pairs.count.dtype == np.int32 and pairs.n_pairs > 0
    assert (pairs.count == 1).all()
    w = want.pairs()
    np.testing.assert_array_equal(pairs.src, np.asarray(w.src))
    np.testing.assert_array_equal(pairs.dst, np.asarray(w.dst))
    np.testing.assert_array_equal(pairs.count, np.asarray(w.count))
    assert got.num_results() == want.num_results()
    assert got.num_pairs() == want.num_pairs()


@pytest.mark.parametrize("route", ["segment", "dense", "dense-kernel"])
@pytest.mark.parametrize("q", [COUNTING_READ, SET_READ])
def test_unfused_rows_have_the_fused_plans_dtype_and_values(q, route):
    ps = build(P, ROUTES[route])
    fused = ps.query(q)
    unfused = P.PathExecutor(engine=ps.engine, cfg=ps.cfg).run_query(
        P.parse_query(q))
    assert unfused.counting == fused.counting
    assert unfused.reach.dtype == fused.reach.dtype == \
        rows_dtype(fused.counting)
    assert unfused.reach.flags.c_contiguous
    np.testing.assert_array_equal(unfused.src_ids, fused.src_ids)
    np.testing.assert_array_equal(unfused.reach, fused.reach)
    assert (unfused.metrics.db_hits, unfused.metrics.rows) == \
        (fused.metrics.db_hits, fused.metrics.rows)


def test_a_view_built_from_set_rows_stores_int32_ones():
    """An unbounded view (set semantics) stores weight 1 on every pair, as
    int32 edge weights, and passes its consistency check."""
    ps = build(P)
    ps.create_view("CREATE VIEW V AS (CONSTRUCT (s)-[r:V]->(d) "
                   "MATCH (s:A)-[:x*1..]->(d:B))")
    lid = ps.schema.edge_label_id("V")
    live = (ps.g.edge_label == lid) & ps.g.edge_alive
    assert int(live.sum()) == ps.query(SET_READ, use_views=False).num_pairs()
    assert ps.g.edge_weight.dtype == torch.int32
    assert (ps.g.edge_weight[live] == 1).all()
    assert ps.check_consistency("V")


@pytest.mark.parametrize("shards", [1, 2])
def test_a_shared_batch_of_set_plans_returns_bool_rows(R, shards):
    ps = build(P, dict(data_shards=shards))
    rs = build(R)
    pp = [ps.planner.plan(P.parse_query(q), [], 0)[0]
          for q in (SET_READ, SET_READ_2)]
    rp = [rs.planner.plan(R.parse_query(q), [], 0)[0]
          for q in (SET_READ, SET_READ_2)]
    key = pp[0].structure_key()
    assert key is not None and key == pp[1].structure_key()
    assert not pp[0].counting
    specs = [[p.default_sources(), np.asarray([3, 4], np.int32)] for p in pp]
    got = ps.planner.shared_program(key).execute(pp, specs)
    want = rs.planner.shared_program(rp[0].structure_key()).execute(rp, specs)
    for gm, wm in zip(got, want):
        for g, w in zip(gm, wm):
            assert g.reach.dtype == np.bool_ and not g.counting
            assert np.asarray(w.reach).dtype == np.int32
            np.testing.assert_array_equal(g.reach, np.asarray(w.reach))
            np.testing.assert_array_equal(g.db_vec, np.asarray(w.db_vec))


def test_a_served_set_read_returns_bool_rows(R):
    ps = build(P)
    eng = ps.serve(ServeConfig())
    t = eng.submit(SET_READ)
    eng.run()
    want = build(R).query(SET_READ)
    assert t.result.reach.dtype == np.bool_
    np.testing.assert_array_equal(t.result.reach, np.asarray(want.reach))


def test_the_force_bool_control_reads_wrong_against_counting_rows(R):
    """The benchmark's control forces set semantics on a counting read: its
    rows are bool, and differ from the counting reference's by value."""
    ps = build(P)
    q = dataclasses.replace(P.parse_query(COUNTING_READ), force_bool=True)
    got = ps.query(q)
    want = build(R).query(COUNTING_READ)
    assert not got.counting and got.reach.dtype == np.bool_
    want_rows = np.asarray(want.reach)
    assert want_rows.max() > 1               # some pair has two walks
    assert (got.reach != want_rows).any()
    np.testing.assert_array_equal(got.reach, want_rows > 0)


@pytest.mark.parametrize("q", [COUNTING_READ, SET_READ])
def test_the_pull_span_counts_its_rows_and_byte_rows(q):
    ps = build(P)
    ps.query(q)                                        # warm the caches
    got, pull = pull_span(lambda: ps.query(q))
    S = int(got.src_ids.shape[0])
    assert S > 0
    assert pull.attrs["rows"] == S
    assert pull.attrs["byte_rows"] == (0 if got.counting else S)
    assert "bytes" not in pull.attrs           # no copy off a host tensor


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def owner(a):
    """The object that holds an ndarray's memory."""
    while isinstance(a, np.ndarray):
        a = a.base
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["segment", "dense-kernel"])
def test_card_set_rows_are_pinned_bool_one_byte_an_entry(card, route):
    on_card, on_host = build(P, ROUTES[route], device="cuda"), \
        build(P, ROUTES[route])
    on_card.query(SET_READ)                            # warm the caches
    got, pull = pull_span(lambda: on_card.query(SET_READ))
    want = on_host.query(SET_READ)
    S, N = got.reach.shape
    assert got.reach.dtype == np.bool_ and got.reach.flags.c_contiguous
    assert N == on_card.g.node_cap
    np.testing.assert_array_equal(got.reach, want.reach)
    pinned = owner(got.reach)
    assert isinstance(pinned, torch.Tensor) and pinned.is_pinned()
    assert pinned.dtype == torch.bool
    assert pull.attrs["rows"] == pull.attrs["byte_rows"] == S
    assert pull.attrs["bytes"] == S * N * 1 + 2 * S * 8    # + db, rows
    counted, pull = pull_span(lambda: on_card.query(COUNTING_READ))
    assert counted.reach.dtype == np.int32
    assert owner(counted.reach).dtype == torch.int32
    assert pull.attrs["byte_rows"] == 0
    assert pull.attrs["bytes"] == counted.reach.nbytes + \
        2 * counted.reach.shape[0] * 8


@pytest.mark.cuda
def test_card_kept_set_results_share_no_memory(card):
    sess = build(P, device="cuda")
    kept = sess.query(SET_READ)
    copy = kept.reach.copy()
    later = [sess.query(SET_READ) for _ in range(2)]
    for r in later:
        assert not np.shares_memory(kept.reach, r.reach)
    assert not np.shares_memory(later[0].reach, later[1].reach)
    np.testing.assert_array_equal(kept.reach, copy)
    np.testing.assert_array_equal(later[1].reach, copy)

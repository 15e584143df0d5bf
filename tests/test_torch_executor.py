"""The port's executor and compiled plans == the reference, bit-exact.

The same seeded graph is built by both packages.  Reach rows, counting mode
and DBHit/Rows must be equal under each backend pair (port ``segment`` /
``dense`` / ``kernel`` — the plain version on the CPU — against reference
``segment`` / ``dense`` / ``pallas`` in interpret mode), on the patterns of
``test_executor.py``, ``test_engine.py`` and ``test_plan_cache.py``.  Fused
plans must equal the unfused executor, and the plan and engine cache
counters must move as the reference's do over the same query and write
sequence (epoch bumps, drop_view, arena growth, config mutation, external
graph swaps).
"""
import numpy as np
import pytest

import repro.core as R
import repro.core.graph as RG
import repro_torch.core as P
import repro_torch.core.graph as PG

# port ExecConfig kwargs, reference ExecConfig kwargs
BACKENDS = {
    "segment": ({"backend": "segment"}, {"backend": "segment"}),
    "dense": ({"backend": "dense"}, {"backend": "dense"}),
    "kernel": ({"backend": "dense", "use_kernel": True},
               {"backend": "dense", "use_pallas": True}),
}

QUERIES = [
    "MATCH (a:A)-[:x*1..3]->(b:B) RETURN a, b",
    "MATCH (a:A)-[:x*2..]->(b) RETURN a, b",
    "MATCH (a:A)-[:x*1..2]->(b:B)-[:y]->(c:A) RETURN a, c",
    "MATCH (p:A)<-[:x]-(q:A) RETURN p, q",
    "MATCH (a:A)-[:x]-(b) RETURN a, b",
    "MATCH (a:A)-[r]->(m) RETURN a, m",
    "MATCH (a:A) RETURN a",
    "MATCH (a:A)-[e:x]->(b:B) WHERE e.w >= 2 RETURN a, b",
    "MATCH (a:A)-[e:x {w: 3}]->(b) RETURN a, b",
    "MATCH (a:A)-[e:x*1..3]->(b:B) WHERE e.w > 1 RETURN a, b",
    "MATCH (a:A)-[e:x*1..]->(b:B) WHERE e.w >= 1 AND b.age <= 5 RETURN a, b",
    "MATCH (a:A)-[:x]->(m:B)-[f:y]->(c) WHERE a.age >= 3 AND m.age < 6 "
    "AND f.w <= 3 RETURN a, c",
    "MATCH (a:A)-[e:x]-(b) WHERE e.w = 2 RETURN a, b",
    "MATCH (a:A)-[:x*0..2]->(b:B) RETURN a, b",
]


def random_graph(pkg, seed, n=12, p=0.25):
    """test_plan_cache's random property graph, built by ``pkg``."""
    rng = np.random.default_rng(seed)
    schema = pkg.GraphSchema()
    b = pkg.GraphBuilder(schema)
    for _ in range(n):
        b.add_node(("A", "B")[rng.integers(2)],
                   props={"age": int(rng.integers(0, 8))})
    for u in range(n):
        for v in range(n):
            if u != v and rng.random() < p:
                b.add_edge(u, v, ("x", "y")[rng.integers(2)],
                           props={"w": int(rng.integers(0, 5))})
    kw = {"device": "cpu"} if pkg is P else {}
    return b.finalize(**kw), schema


def toy_graph(pkg, edge_cap=1024):
    """test_engine's toy graph: an x chain and a y fan."""
    schema = pkg.GraphSchema()
    b = pkg.GraphBuilder(schema)
    nodes = [b.add_node("A" if i % 2 == 0 else "B") for i in range(8)]
    for i in range(7):
        b.add_edge(nodes[i], nodes[i + 1], "x")
    for i in range(0, 8, 2):
        b.add_edge(nodes[i], nodes[(i + 3) % 8], "y")
    kw = {"device": "cpu"} if pkg is P else {}
    return b.finalize(edge_cap=edge_cap, **kw), schema


def session(pkg, g, schema, **cfg):
    kw = {"device": "cpu"} if pkg is P else {}
    return pkg.GraphSession(g, schema, pkg.ExecConfig(**cfg) if cfg else None,
                            **kw)


def rows_dtype(res):
    """The rows' dtype: the reference's are int32; the port's are int32
    walk counts, or bool under set semantics."""
    if isinstance(res, P.ReachResult) and not res.counting:
        return np.bool_
    return np.int32


def assert_same_result(rp, rr, what):
    np.testing.assert_array_equal(rp.src_ids, rr.src_ids, err_msg=what)
    assert rp.reach.dtype == rows_dtype(rp), what
    assert rr.reach.dtype == rows_dtype(rr), what
    np.testing.assert_array_equal(rp.reach, rr.reach, err_msg=what)
    assert rp.counting == rr.counting, what
    assert (rp.metrics.db_hits, rp.metrics.rows) == \
        (rr.metrics.db_hits, rr.metrics.rows), what


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_unfused_executor_matches_reference(backend, seed):
    gp, sp = random_graph(P, seed)
    gr, sr = random_graph(R, seed)
    pkw, rkw = BACKENDS[backend]
    ep = P.PathExecutor(gp, sp, P.ExecConfig(src_block=16, **pkw))
    er = R.PathExecutor(gr, sr, R.ExecConfig(src_block=16, **rkw))
    for q in QUERIES:
        assert_same_result(ep.run_query(P.parse_query(q)),
                           er.run_query(R.parse_query(q)), f"{backend}: {q}")


@pytest.mark.parametrize("seed", [1, 4])
def test_ported_backends_agree(seed):
    """segment, dense and kernel hops of the port give one answer."""
    gp, sp = random_graph(P, seed)
    res = {name: [P.PathExecutor(gp, sp, P.ExecConfig(src_block=16, **kw))
                  .run_query(P.parse_query(q)) for q in QUERIES]
           for name, (kw, _) in BACKENDS.items()}
    for name in ("dense", "kernel"):
        for q, a, b in zip(QUERIES, res[name], res["segment"]):
            assert_same_result(a, b, f"{name} vs segment: {q}")


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("plan_backend", ["auto", "dense", "kernel"])
def test_fused_plan_matches_reference_and_unfused(plan_backend, seed):
    gp, sp = random_graph(P, seed)
    gr, sr = random_graph(R, seed)
    ref_backend = "pallas" if plan_backend == "kernel" else plan_backend
    kernel = plan_backend == "kernel"
    ps = session(P, gp, sp, src_block=16, plan_backend=plan_backend,
                 use_kernel=kernel)
    rs = session(R, gr, sr, src_block=16, plan_backend=ref_backend,
                 use_pallas=kernel)
    unfused = "segment" if plan_backend == "auto" else "dense"
    ex = P.PathExecutor(gp, sp, P.ExecConfig(backend=unfused, src_block=16,
                                             use_kernel=kernel))
    for q in QUERIES:
        rp = ps.query(q, use_views=False)
        assert_same_result(rp, rs.query(q, use_views=False), f"ref: {q}")
        assert_same_result(rp, ex.run_query(P.parse_query(q)), f"unfused: {q}")


def test_plan_steps_match_reference():
    """Physical plans pick the same backend per hop ("pallas" is "kernel")."""
    gp, sp = random_graph(P, 2)
    gr, sr = random_graph(R, 2)
    for cfg in ({}, {"backend": "dense"}, {"dense_node_limit": 1 << 20,
                                           "dense_density": 0.01}):
        ps, rs = session(P, gp, sp, **cfg), session(R, gr, sr, **cfg)
        for q in QUERIES:
            ps.query(q, use_views=False)
            rs.query(q, use_views=False)
        for (kp, plan_p), (kr, plan_r) in zip(ps.planner._plans.items(),
                                              rs.planner._plans.items()):
            assert kp[1] == kr[1]
            got = [(type(s).__name__, getattr(s, "backend", None))
                   for s in plan_p.steps]
            want = [(type(s).__name__, getattr(s, "backend", None))
                    for s in plan_r.steps]
            assert got == want, cfg


def test_fused_plan_matches_unfused_after_rewrite():
    gp, sp = toy_graph(P)
    ps = session(P, gp, sp)
    ps.create_view("CREATE VIEW VX AS (CONSTRUCT (s)-[r:VX]->(d) "
                   "MATCH (s:A)-[:x*1..2]->(d:B))")
    q = "MATCH (a:A)-[:x*1..2]->(b:B)-[:y]->(c:A) RETURN a, c"
    q_rw = P.optimize_query(P.parse_query(q), list(ps.views.values()))
    assert any(r.label == "VX" for r in q_rw.path.rels)
    rp = ps.query(q, use_views=True)
    assert_same_result(rp, P.PathExecutor(engine=ps.engine, cfg=ps.cfg)
                       .run_query(q_rw), q)
    np.testing.assert_array_equal(rp.reach,
                                  ps.query(q, use_views=False).reach)


QX = "MATCH (a:A)-[:x*1..2]->(b:B) RETURN a, b"
QY = "MATCH (a:A)-[:y]->(b) RETURN a, b"
QW = "MATCH (a:A)-[r]->(m) RETURN a, m"
VIEW_X = ("CREATE VIEW VX AS (CONSTRUCT (s)-[r:VX]->(d) "
          "MATCH (s:A)-[:x*1..2]->(d:B))")
VIEW_Y = ("CREATE VIEW VY AS (CONSTRUCT (s)-[r:VY]->(d) "
          "MATCH (s:A)-[:y]->(d:B))")


def _script(pkg, G):
    """One query/write sequence covering every plan-invalidation key."""
    def swap(s):
        s.g = G.delete_edge(s.g, 0)          # unknown delta: reset fence

    def grow(s):
        cap0 = s.g.node_cap
        while s.g.node_cap == cap0:
            s.create_node("C")

    def mutate_cfg(s):
        s.cfg.max_closure_iters = 128

    return [
        ("query x", lambda s: s.query(QX, use_views=False)),
        ("repeat x", lambda s: s.query(QX, use_views=False)),
        ("renamed vars", lambda s: s.query(
            "MATCH (foo:A)-[:x*1..2]->(bar:B) RETURN foo, bar",
            use_views=False)),
        ("query y", lambda s: s.query(QY, use_views=False)),
        ("wildcard", lambda s: s.query(QW, use_views=False)),
        ("create VX", lambda s: s.create_view(VIEW_X)),
        ("create VY", lambda s: s.create_view(VIEW_Y)),
        ("wildcard after views", lambda s: s.query(QW, use_views=False)),
        ("x via views", lambda s: s.query(QX, use_views=True)),
        ("x via views again", lambda s: s.query(QX, use_views=True)),
        ("y write", lambda s: s.create_edge(0, 3, "y")),
        ("x after y write", lambda s: s.query(QX, use_views=False)),
        ("x write", lambda s: s.create_edge(0, 3, "x")),
        ("x after x write", lambda s: s.query(QX, use_views=False)),
        ("x views after x write", lambda s: s.query(QX, use_views=True)),
        ("drop VX", lambda s: s.drop_view("VX")),
        ("x views after drop", lambda s: s.query(QX, use_views=True)),
        ("grow node arena", grow),
        ("x after growth", lambda s: s.query(QX, use_views=False)),
        ("mutate cfg", mutate_cfg),
        ("x after cfg", lambda s: s.query(QX, use_views=False)),
        ("external swap", swap),
        ("x after swap", lambda s: s.query(QX, use_views=False)),
        ("wildcard after swap", lambda s: s.query(QW, use_views=False)),
    ]


def _counters(s):
    pl = s.planner
    return {"plan": (pl.plan_hits, pl.plan_misses),
            "rewrite": (pl.rewrite_hits, pl.rewrite_misses),
            "engine": (s.engine.hits, s.engine.misses),
            "cached": sorted(s.engine.cached_edge_labels()),
            "reset_gen": s.engine.epochs.reset_generation,
            "view_gen": s.view_set_generation}


def test_cache_counters_follow_reference():
    gp, sp = toy_graph(P)
    gr, sr = toy_graph(R)
    ps, rs = session(P, gp, sp), session(R, gr, sr)
    for (name, fp), (_, fr) in zip(_script(P, PG), _script(R, RG)):
        out_p, out_r = fp(ps), fr(rs)
        if isinstance(out_p, P.ReachResult):
            assert_same_result(out_p, out_r, name)
        assert _counters(ps) == _counters(rs), name
    assert ps.planner.plan_misses > 5     # every fence above recompiled


def test_engine_evicts_only_touched_labels():
    gp, sp = toy_graph(P)
    ps = session(P, gp, sp)
    xid, yid = sp.edge_label_id("x"), sp.edge_label_id("y")
    ps.query(QX, use_views=False)
    ps.query(QY, use_views=False)
    ex, ey = ps.engine.epochs.of(xid), ps.engine.epochs.of(yid)
    ps.create_edge(0, 3, "x")
    assert ps.engine.cached_edge_labels() == {yid}
    assert (ps.engine.epochs.of(xid), ps.engine.epochs.of(yid)) == (ex + 1, ey)
    misses = ps.engine.misses
    ps.query(QY, use_views=False)
    assert ps.engine.misses == misses
    ps.query(QX, use_views=False)
    assert ps.engine.misses > misses


def test_unconverged_closure_raises_like_reference():
    gp, sp = toy_graph(P)
    gr, sr = toy_graph(R)
    q = "MATCH (a:A)-[:x*1..]->(b) RETURN a, b"
    for pkg, g, s in ((P, gp, sp), (R, gr, sr)):
        with pytest.raises(RuntimeError, match="converge"):
            pkg.PathExecutor(g, s, pkg.ExecConfig(max_closure_iters=2)) \
                .run_query(pkg.parse_query(q))
        with pytest.raises(RuntimeError, match="converge"):
            session(pkg, g, s, max_closure_iters=2).query(q, use_views=False)

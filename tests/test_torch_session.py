"""Port GraphSession vs reference GraphSession: a differential oracle.

Both packages build the same seeded graph and receive the same seeded write
stream.  At every step the assigned slots, the graph arrays, every view's
stored pairs and queue, the maintenance metrics, and every read's rows and
DBHit/Rows (through the views and without them) must be equal — under all
three refresh policies (``EXACT``, ``REFRESH DEFERRED``, ``REFRESH
STALENESS n``).  The paper workload runs end to end on both packages at a
small scale: ``snb_like`` and ``finbench_like``, 3 views, 7 reads, CE/DE/DV.
"""
import numpy as np
import pytest

import repro.core as R
import repro.core.graph as RG
import repro_torch.core as P
import repro_torch.core.graph as PG
from repro.configs import mv4pg as r_wl
from repro.data import synthetic as r_syn
from repro_torch.configs import mv4pg as p_wl
from repro_torch.data import synthetic as p_syn

GRAPH = {R: RG, P: PG}

VIEWS = [
    "CREATE VIEW V0 AS (CONSTRUCT (s)-[r:V0]->(d) "
    "MATCH (s:A)-[e:x]->(m:B)-[f:x]->(d) WHERE e.w >= 2)",
    "CREATE VIEW V1 AS (CONSTRUCT (s)-[r:V1]->(d) "
    "MATCH (s:A)-[:x]->(m:B)-[:y]->(d:A) WHERE m.age <= 5)",
    "CREATE VIEW V2 AS (CONSTRUCT (s)-[r:V2]->(d) "
    "MATCH (s:A)-[e:x*1..2]->(d:B) WHERE s.age >= 3)",
    "CREATE VIEW V3 AS (CONSTRUCT (s)-[r:V3]->(d) "
    "MATCH (s:A)-[e:x*1..]->(d:B) WHERE e.w >= 1)",
    "CREATE VIEW V4 AS (CONSTRUCT (d)-[r:V4]->(s) "
    "MATCH (s:A)-[e:x {w: 2}]->(m:B)-[f:y]->(d))",
]

QUERIES = [
    "MATCH (s:A)-[e:x]->(m:B)-[f:x]->(d) WHERE e.w >= 2 RETURN s, d",
    "MATCH (s:A)-[e:x*1..2]->(d:B) WHERE s.age >= 4 RETURN s, d",
    "MATCH (s:A)-[e:x*1..]->(d:B) WHERE e.w >= 1 RETURN s, d",
    "MATCH (s:B)-[e:y]->(d) WHERE e.w <= 3 AND d.age > 2 RETURN s, d",
    "MATCH (s:A)-[:x]->(m:B)-[:y]->(d:A) WHERE m.age <= 5 RETURN s, d",
    "MATCH (a:A)-[r]->(m) RETURN a, m",
]

POLICIES = ["", " REFRESH DEFERRED", " REFRESH STALENESS 3"]
N_NODES = 9
STEPS = 14


def build(pkg, seed):
    rng = np.random.default_rng(seed)
    schema = pkg.GraphSchema()
    b = pkg.GraphBuilder(schema)
    for _ in range(N_NODES):
        b.add_node(("A", "B")[rng.integers(2)],
                   props={"age": int(rng.integers(0, 8))})
    eids = []
    for u in range(N_NODES):
        for v in range(N_NODES):
            if u != v and rng.random() < 0.18:
                eids.append(b.add_edge(u, v, ("x", "y")[rng.integers(2)],
                                       props={"w": int(rng.integers(0, 5))}))
    kw = {"device": "cpu"} if pkg is P else {}
    g = b.finalize(edge_cap=256, **kw)
    sess = pkg.GraphSession(g, schema, **kw)
    return sess, eids


def random_ops(rng, nodes, edges):
    """One random write batch as plain tuples (realized per package)."""
    ops = []
    for _ in range(int(rng.integers(1, 4))):
        kind = rng.choice(["ce", "de", "ep", "np", "cn", "dn"],
                          p=[0.30, 0.20, 0.22, 0.18, 0.05, 0.05])
        if kind == "ce" and len(nodes) >= 2:
            u, v = rng.choice(nodes, size=2, replace=False)
            ops.append(("ce", int(u), int(v), ("x", "y")[rng.integers(2)],
                        int(rng.integers(0, 5))))
        elif kind == "de" and edges:
            ops.append(("de", int(edges[rng.integers(len(edges))])))
        elif kind == "ep" and edges:
            ops.append(("ep", int(edges[rng.integers(len(edges))]),
                        int(rng.integers(0, 5))))
        elif kind == "np" and nodes:
            ops.append(("np", int(nodes[rng.integers(len(nodes))]),
                        int(rng.integers(0, 8))))
        elif kind == "cn":
            ops.append(("cn", ("A", "B")[rng.integers(2)],
                        int(rng.integers(0, 8))))
        elif kind == "dn" and len(nodes) > 4:
            ops.append(("dn", int(nodes[rng.integers(len(nodes))])))
    return ops


def make_batch(pkg, ops):
    wb = pkg.WriteBatch()
    for op in ops:
        if op[0] == "ce":
            wb.create_edge(op[1], op[2], op[3], props={"w": op[4]})
        elif op[0] == "de":
            wb.delete_edge(op[1])
        elif op[0] == "ep":
            wb.set_edge_prop(op[1], "w", op[2])
        elif op[0] == "np":
            wb.set_node_prop(op[1], "age", op[2])
        elif op[0] == "cn":
            wb.create_node(op[1], props={"age": op[2]})
        else:
            wb.delete_node(op[1])
    return wb


def graph_arrays(g):
    cols = ("node_label", "node_key", "node_alive", "edge_src", "edge_dst",
            "edge_label", "edge_alive", "edge_weight")
    out = {c: np.asarray(getattr(g, c)) for c in cols}
    for kind in ("node_props", "edge_props"):
        out.update({f"{kind}.{k}": np.asarray(v)
                    for k, v in getattr(g, kind).items()})
    return out


def assert_same_state(ps, rs, what):
    a, b = graph_arrays(ps.g), graph_arrays(rs.g)
    assert sorted(a) == sorted(b), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")
    assert sorted(ps.views) == sorted(rs.views), what
    for name, vp in ps.views.items():
        vr = rs.views[name]
        assert vp.pair_slot == vr.pair_slot, f"{what}: {name} pairs"
        assert vp.label_id == vr.label_id, what
        assert vp.pending.writes == vr.pending.writes, f"{what}: {name}"
        assert vp.pending.staleness(ps.write_epoch) == \
            vr.pending.staleness(rs.write_epoch), f"{what}: {name}"
        assert vp.drain_epoch == vr.drain_epoch, f"{what}: {name}"
    assert ps.write_epoch == rs.write_epoch, what
    mp, mr = ps.last_maintenance_metrics, rs.last_maintenance_metrics
    assert (mp.db_hits, mp.rows) == (mr.db_hits, mr.rows), what


def assert_same_read(rp, rr, what):
    np.testing.assert_array_equal(rp.src_ids, rr.src_ids, err_msg=what)
    np.testing.assert_array_equal(rp.reach, rr.reach, err_msg=what)
    assert rp.counting == rr.counting, what
    assert (rp.metrics.db_hits, rp.metrics.rows) == \
        (rr.metrics.db_hits, rr.metrics.rows), what


def live_base_edges(sess, ids):
    alive = np.asarray(sess.g.edge_alive)
    lab = np.asarray(sess.g.edge_label)
    return sorted(e for e in ids if bool(alive[e])
                  and not sess.schema.is_view_edge_label_id(int(lab[e])))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", POLICIES,
                         ids=["exact", "deferred", "staleness"])
def test_differential_against_reference(policy, seed):
    rng = np.random.default_rng(seed + 700)
    (ps, eids), (rs, _) = build(P, seed), build(R, seed)
    picks = sorted(rng.choice(len(VIEWS), size=3, replace=False))
    for i in picks:
        ps.create_view(VIEWS[i] + policy)
        rs.create_view(VIEWS[i] + policy)
    assert_same_state(ps, rs, "after create_view")
    nodes, edges = list(range(N_NODES)), list(eids)
    saw_stale = False
    for step in range(STEPS):
        ops = random_ops(rng, nodes, edges)
        res_p = ps.apply_writes(make_batch(P, ops))
        res_r = rs.apply_writes(make_batch(R, ops))
        what = f"seed={seed} step={step} {policy.strip() or 'EXACT'} {ops}"
        np.testing.assert_array_equal(res_p.edge_slots, res_r.edge_slots)
        np.testing.assert_array_equal(res_p.node_slots, res_r.node_slots)
        assert_same_state(ps, rs, what)
        saw_stale = saw_stale or any(v.is_stale for v in ps.views.values())
        # mirror the live id sets (both sessions agree, so read one)
        edges = live_base_edges(ps, set(edges) | {int(s) for s in
                                                  res_p.edge_slots})
        dead = {op[1] for op in ops if op[0] == "dn"}
        alive_n = np.asarray(ps.g.node_alive)
        nodes = sorted(n for n in set(nodes) - dead
                       | {int(s) for s in res_p.node_slots} if alive_n[n])
        for q in QUERIES:
            for use_views in (True, False):
                assert_same_read(ps.query(q, use_views=use_views),
                                 rs.query(q, use_views=use_views),
                                 f"{what}: {q} views={use_views}")
        assert_same_state(ps, rs, f"{what} after reads")
        if step % 5 == 4:
            assert ps.refresh() == rs.refresh(), what
            assert_same_state(ps, rs, f"{what} after refresh")
            for name in ps.views:
                assert ps.check_consistency(name), f"{what}: {name}"
                assert rs.check_consistency(name), f"{what}: {name}"
    assert saw_stale == bool(policy), "non-exact policies must queue deltas"


@pytest.mark.parametrize("policy", POLICIES,
                         ids=["exact", "deferred", "staleness"])
def test_single_op_writes_and_drains_match_reference(policy):
    (ps, eids), (rs, _) = build(P, 5), build(R, 5)
    for i in (0, 2, 3):
        ps.create_view(VIEWS[i] + policy)
        rs.create_view(VIEWS[i] + policy)
    for s in (ps, rs):
        x = int(np.flatnonzero(np.asarray(s.g.node_label) == 0)[0])
        s.set_node_prop(x, "age", 6)
        slot = s.create_edge(x, 3, "x", props={"w": 2})
        s.set_edge_prop(slot, "w", 4)
        s.delete_edge(eids[1])
        s.create_node("B", key=42)
        s.delete_node(5)
    assert_same_state(ps, rs, "single-op writes")
    assert [h.is_stale for h in ps.catalog()] == \
        [h.is_stale for h in rs.catalog()]
    assert ps.view("V2").drain() == rs.view("V2").drain()
    assert ps.drain_view("V0") == rs.drain_view("V0")
    assert_same_state(ps, rs, "partial drains")
    ps.drain_all()
    rs.drain_all()
    assert_same_state(ps, rs, "drain_all")
    for name in ps.views:
        assert ps.check_consistency(name) and rs.check_consistency(name)


def test_view_build_paths_and_handles_match_reference():
    (ps, _), (rs, _) = build(P, 2), build(R, 2)
    for i, v in enumerate(VIEWS):
        hp = ps.create_view(v, fused=bool(i % 2))
        hr = rs.create_view(v)
        sp, sr = hp.stats(), hr.stats()
        assert (sp.n_sl, sp.e_vl, sp.init_db_hit, sp.opt_rate,
                sp.pending_writes, sp.stale) == \
            (sr.n_sl, sr.e_vl, sr.init_db_hit, sr.opt_rate,
             sr.pending_writes, sr.stale), v
        assert hp.policy.pretty() == hr.policy.pretty()
        assert sp.opt_eff() == sr.opt_eff()
    assert_same_state(ps, rs, "five views")
    ps.view("V1").drop()
    rs.drop_view("V1")
    ps.drop_view("V3")
    rs.view("V3").drop()
    assert_same_state(ps, rs, "after drops")
    assert repr(ps.view("V0")) == repr(rs.view("V0"))
    with pytest.raises(ValueError):
        ps.view("V1")
    for q in QUERIES:
        assert_same_read(ps.query(q), rs.query(q), q)


def test_unported_surfaces_name_their_roadmap_item():
    ps, _ = build(P, 0)
    h = ps.create_view(VIEWS[0])
    for call, item in ((h.subgraph, "A9"), (h.sampler, "A9"),
                       (h.to_graphbatch, "A9"), (ps.serve, "A8"),
                       (ps.selection_stats, "A7")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    with pytest.raises(NotImplementedError, match="A7"):
        ps.select_views([QUERIES[0]])


# ---------------------------------------------------------------------------
# the paper workload end to end, scaled down
# ---------------------------------------------------------------------------

def _workload_graph(pkg, name):
    syn, kw = (p_syn, {"device": "cpu"}) if pkg is P else (r_syn, {})
    if name == "snb":
        return syn.snb_like(seed=0, n_person=40, n_post=30, n_comment=240,
                            n_place=6, n_tag=12, slack=1.5, **kw)
    return syn.finbench_like(seed=0, n_account=160, n_person=60,
                             n_company=20, n_loan=32, slack=1.5, **kw)


def _ce_de_dv(pkg, sess, seed=0):
    """CE, DE and DV with recover, as the paper workload driver runs them."""
    rng = np.random.default_rng(seed)
    g = sess.g
    alive = np.flatnonzero(np.asarray(g.edge_alive))
    view_lids = {v.label_id for v in sess.views.values()}
    e_lab = np.asarray(g.edge_label)
    base = alive[~np.isin(e_lab[alive], sorted(view_lids))]
    eid = int(rng.choice(base))
    src, dst = int(np.asarray(g.edge_src)[eid]), int(np.asarray(g.edge_dst)[eid])
    elabel = sess.schema.edge_labels.name_of(int(e_lab[eid]))
    nid = int(rng.choice(np.flatnonzero(np.asarray(g.node_alive))))
    sess.delete_edge(sess.create_edge(src, dst, elabel))     # CE + recover
    sess.delete_edge(eid)                                    # DE
    sess.create_edge(src, dst, elabel)                       # recover
    g = sess.g                                               # DV
    e_alive, e_src = np.asarray(g.edge_alive), np.asarray(g.edge_src)
    e_dst, e_lab = np.asarray(g.edge_dst), np.asarray(g.edge_label)
    inc = np.flatnonzero(e_alive & ((e_src == nid) | (e_dst == nid)))
    nlabel = int(np.asarray(g.node_label)[nid])
    nkey = int(np.asarray(g.node_key)[nid])
    sess.delete_node(nid)
    sess.g = GRAPH[pkg].create_node(sess.g, nid, nlabel, nkey)   # recover
    for e in inc:
        if int(e_lab[e]) not in view_lids:
            sess.create_edge(int(e_src[e]), int(e_dst[e]),
                             sess.schema.edge_labels.name_of(int(e_lab[e])))


@pytest.mark.parametrize("name", ["snb", "finbench"])
def test_paper_workload_matches_reference(name):
    wl_p = p_wl.WORKLOADS[name]
    wl_r = r_wl.WORKLOADS[name]
    assert (wl_p.views, wl_p.reads) == (wl_r.views, wl_r.reads)
    sessions = {}
    for pkg in (P, R):
        g, schema, _ = _workload_graph(pkg, name)
        kw = {"device": "cpu"} if pkg is P else {}
        sessions[pkg] = pkg.GraphSession(g, schema, **kw)
    ps, rs = sessions[P], sessions[R]
    assert_same_state(ps, rs, "generated graph")
    base = []
    for q in wl_p.reads:
        rp = ps.query(q, use_views=False)
        assert_same_read(rp, rs.query(q, use_views=False), q)
        base.append(rp)
    assert sum(r.num_results() for r in base) > 0
    for v in wl_p.views:
        ps.create_view(v)
        rs.create_view(v)
    assert_same_state(ps, rs, "views built")
    for q, rb in zip(wl_p.reads, base):
        rp = ps.query(q, use_views=True)
        assert_same_read(rp, rs.query(q, use_views=True), q)
        np.testing.assert_array_equal(rp.reach, rb.reach, err_msg=q)
    for seed in range(2):
        _ce_de_dv(P, ps, seed)
        _ce_de_dv(R, rs, seed)
        assert_same_state(ps, rs, f"CE/DE/DV {seed}")
        for view in ps.views:
            assert ps.check_consistency(view) and rs.check_consistency(view)
    for q in wl_p.reads:
        assert_same_read(ps.query(q), rs.query(q), f"after writes: {q}")

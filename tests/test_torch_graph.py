"""The port's graph arena == the reference's, after finalize and every write.

Both packages build the same seeded graph; every array (node/edge columns,
alive masks, weights, property columns) must be equal after ``finalize``,
after each functional write kind, after ``apply_writes`` batches and after
node/edge arena growth.  A write must also leave the tensors of every
earlier graph object untouched (maintenance reads old and new graphs side
by side).
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.graph as RG
import repro_torch.core as P
import repro_torch.core.graph as PG
from repro_torch.interop import graph_from_arrays, schema_from_labels

FIELDS = ("node_label", "node_key", "node_alive", "edge_src", "edge_dst",
          "edge_label", "edge_alive", "edge_weight")


def arrays(g) -> dict:
    out = {f: np.asarray(getattr(g, f)) for f in FIELDS}
    for kind in ("node_props", "edge_props"):
        out[kind] = {k: np.asarray(v) for k, v in getattr(g, kind).items()}
    return out


def assert_same(gp, gr):
    a, b = arrays(gp), arrays(gr)
    for f in FIELDS:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for kind in ("node_props", "edge_props"):
        assert sorted(a[kind]) == sorted(b[kind]), kind
        for k in a[kind]:
            assert a[kind][k].dtype == np.int32
            np.testing.assert_array_equal(a[kind][k], b[kind][k],
                                          err_msg=f"{kind}[{k}]")


def build(pkg, seed=0, n=14, p=0.2, **fin):
    rng = np.random.default_rng(seed)
    schema = pkg.GraphSchema()
    b = pkg.GraphBuilder(schema)
    for i in range(n):
        b.add_node(("A", "B")[rng.integers(2)],
                   key=None if i % 3 else 100 + i,
                   props={"age": int(rng.integers(0, 8))} if i % 2 else None)
    for u in range(n):
        for v in range(n):
            if u != v and rng.random() < p:
                b.add_edge(u, v, ("x", "y")[rng.integers(2)],
                           props={"w": int(rng.integers(0, 5))})
    if pkg is P:
        fin.setdefault("device", "cpu")
    return b.finalize(**fin), schema


@pytest.mark.parametrize("caps", [{}, {"node_cap": 256, "edge_cap": 512},
                                  {"slack": 3.0}])
def test_finalize_matches_reference(caps):
    gp, sp = build(P, **caps)
    gr, sr = build(R, **caps)
    assert_same(gp, gr)
    assert (gp.node_cap, gp.edge_cap) == (gr.node_cap, gr.edge_cap)
    assert sp.node_labels._to_name == sr.node_labels._to_name
    assert sp.edge_labels._to_name == sr.edge_labels._to_name


def test_interop_rebuilds_reference_state():
    gr, sr = build(R, seed=4)
    gp = graph_from_arrays(arrays(gr), device="cpu")
    assert_same(gp, gr)
    sp = schema_from_labels(sr.node_labels._to_name, sr.edge_labels._to_name,
                            ["x"])
    assert sp.edge_label_id("y") == sr.edge_label_id("y")
    assert sp.is_view_edge_label("x") and not sp.is_view_edge_label("y")


def _host_copy(g):
    return {k: (v.copy() if isinstance(v, np.ndarray)
                else {n: c.copy() for n, c in v.items()})
            for k, v in arrays(g).items()}


WRITES = [
    ("delete_edge", lambda M, g: M.delete_edge(g, 3)),
    ("delete_edges", lambda M, g: M.delete_edges(g, np.array([1, 4, 6]))),
    ("create_edge", lambda M, g: M.create_edge(g, int(M.free_edge_slots(g, 1)[0]),
                                               2, 5, 1, 3)),
    ("create_edges", lambda M, g: M.create_edges(
        g, M.free_edge_slots(g, 3), np.array([0, 1, 2]), np.array([3, 4, 5]),
        0, np.array([1, 2, 3]))),
    ("delete_node", lambda M, g: M.delete_node(g, 2)),
    ("delete_nodes", lambda M, g: M.delete_nodes(g, np.array([1, 5]))),
    ("create_node", lambda M, g: M.create_node(
        g, int(M.free_node_slots(g, 1)[0]), 1, 77)),
    ("create_nodes", lambda M, g: M.create_nodes(
        g, M.free_node_slots(g, 2), np.array([0, 1]), np.array([7, 8]))),
    ("set_node_props", lambda M, g: M.set_node_props(g, [0, 3], "age", [5, 6])),
    ("set_node_props_new", lambda M, g: M.set_node_props(g, [2], "rank", [9])),
    ("set_edge_props", lambda M, g: M.set_edge_props(g, [0, 2], "w", [7, 8])),
    ("add_edge_weight", lambda M, g: M.add_edge_weight(
        g, np.array([0, 1, 0]), np.array([2, -1, 1]))),
    ("grow_node_arena", lambda M, g: M.grow_node_arena(g, g.node_cap + 200)),
    ("grow_edge_arena", lambda M, g: M.grow_edge_arena(g, g.edge_cap + 300)),
]


@pytest.mark.parametrize("name,write", WRITES, ids=[w[0] for w in WRITES])
def test_write_matches_reference_and_leaves_old_graph(name, write):
    gp, _ = build(P, seed=1)
    gr, _ = build(R, seed=1)
    # recycle a slot first so slot-clearing of property columns is covered
    gp, gr = PG.delete_edge(gp, 0), RG.delete_edge(gr, 0)
    before = _host_copy(gp)
    gp2, gr2 = write(PG, gp), write(RG, gr)
    assert_same(gp2, gr2)
    # aliasing hazard: the old graph object's tensors must be unchanged
    after = _host_copy(gp)
    for k, v in before.items():
        if isinstance(v, dict):
            assert sorted(v) == sorted(after[k])
            for n in v:
                np.testing.assert_array_equal(v[n], after[k][n])
        else:
            np.testing.assert_array_equal(v, after[k], err_msg=k)


def test_masks_and_lookups_match():
    gp, sp = build(P, seed=2)
    gr, sr = build(R, seed=2)
    for lid in (-1, 0, 1):
        np.testing.assert_array_equal(gp.node_mask(lid).numpy(),
                                      np.asarray(gr.node_mask(lid)))
        np.testing.assert_array_equal(gp.edge_mask(lid).numpy(),
                                      np.asarray(gr.edge_mask(lid)))
    preds = (P.PropPred("age", ">=", 3),)
    rpreds = (R.PropPred("age", ">=", 3),)
    np.testing.assert_array_equal(P.node_pred_mask(gp, preds).numpy(),
                                  np.asarray(R.node_pred_mask(gr, rpreds)))
    epreds, erpreds = (P.PropPred("w", "<", 2),), (R.PropPred("w", "<", 2),)
    np.testing.assert_array_equal(P.edge_pred_mask(gp, epreds).numpy(),
                                  np.asarray(R.edge_pred_mask(gr, erpreds)))
    lid0 = int(np.asarray(gr.node_label)[0])
    assert P.find_node(gp, lid0, 100) == R.find_node(gr, lid0, 100) == 0
    for a, b in zip(PG.edges_of(gp), RG.edges_of(gr)):
        np.testing.assert_array_equal(a, b)
    assert gp.num_nodes() == int(gr.num_nodes())
    assert gp.num_edges() == int(gr.num_edges())


def _batches(pkg):
    """Write batches of every kind (mirrored in both packages)."""
    W = pkg.WriteBatch
    return [
        W(edge_creates=[(0, 5, "x"), (2, 7, "y")], edge_deletes=[1, 3]),
        W().create_node("A", 55, props={"age": 4}).create_node("B"),
        W(node_deletes=[4], edge_deletes=[6]),
        W().set_node_prop(3, "age", 7).set_edge_prop(8, "w", 1),
        W().create_edge(1, 9, "x", props={"w": 4}).delete_node(9),
        W(edge_creates=[(6, 7, "x")] * 40),    # forces edge-arena growth
        W(node_creates=[("A", None)] * 150),   # forces node-arena growth
    ]


@pytest.mark.parametrize("step", range(7))
def test_apply_writes_batches_match_reference(step):
    gp, sp = build(P, seed=3, edge_cap=128)
    gr, sr = build(R, seed=3, edge_cap=128)
    views = ["CREATE VIEW VC AS (CONSTRUCT (s)-[r:VC]->(d) "
             "MATCH (s:A)-[:x*1..2]->(d:B))"]
    ps = P.GraphSession(gp, sp, device="cpu")
    rs = R.GraphSession(gr, sr)
    for v in views:
        ps.create_view(v)
        rs.create_view(v)
    for bp, br in zip(_batches(P)[:step + 1], _batches(R)[:step + 1]):
        old = ps.g
        old_copy = _host_copy(old)
        resp, resr = ps.apply_writes(bp), rs.apply_writes(br)
        np.testing.assert_array_equal(resp.edge_slots, resr.edge_slots)
        np.testing.assert_array_equal(resp.node_slots, resr.node_slots)
        for k, v in old_copy.items():      # no write lands in an old graph
            if not isinstance(v, dict):
                np.testing.assert_array_equal(v, _host_copy(old)[k])
    assert_same(ps.g, rs.g)
    assert ps.check_consistency("VC") and rs.check_consistency("VC")
    assert ps.views["VC"].pair_slot == rs.views["VC"].pair_slot


def test_session_create_node_grows_like_reference():
    gp, sp = build(P, seed=5)
    gr, sr = build(R, seed=5)
    ps = P.GraphSession(gp, sp, device="cpu")
    rs = R.GraphSession(gr, sr)
    cap0 = ps.g.node_cap
    while ps.g.node_cap == cap0:
        assert ps.create_node("C") == rs.create_node("C")
    assert_same(ps.g, rs.g)
    assert ps.engine.epochs.reset_generation == \
        rs.engine.epochs.reset_generation


def test_graph_to_device_roundtrip():
    gp, _ = build(P, seed=6)
    g2 = gp.to(torch.device("cpu"))
    assert_same(g2, gp)

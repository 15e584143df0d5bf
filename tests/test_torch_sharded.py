"""Sharded execution == the reference's single-device session, bit for bit.

The reference's contract for ``ExecConfig(data_shards=N)`` (DESIGN.md §12,
``tests/test_sharded.py``) is that N shards give the single-device answer:
rows, DBHit, Rows and closure trip counts.  The reference's own sharded
path does not run on this jax, so the port's N-shard session (N logical
shards on the CPU, ``shard_devices`` defaulting to ``["cpu"] * N``) is held
to the reference's **unsharded** session on the same seeded graph, over
the reference suite's five scenarios: the compiled plans, the serve
workload under three freshness policies, maintenance sweeps routed to
owner shards, arena growth re-partitioning every shard, and the device
list.  Unit cases hold ``partition_hop_edges`` and ``owner_order`` to the
reference's on seeded inputs.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as R
import repro.graphops.distributed as r_dist
import repro.core.maintenance as r_maint
from repro.serve import engine as r_serve
import repro_torch.core as P
import repro_torch.core.maintenance as p_maint
import repro_torch.graphops.distributed as p_dist
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import engine as p_serve

QUERIES = [
    "MATCH (s:A)-[e:x]->(m:B)-[f:x]->(d) WHERE e.w >= 2 RETURN s, d",
    "MATCH (s:A)-[e:x*1..2]->(d:B) WHERE s.age >= 4 RETURN s, d",
    "MATCH (s:A)-[e:x*1..]->(d:B) WHERE e.w >= 1 RETURN s, d",
    "MATCH (s:A)-[:x]->(m:B)<-[:y]-(d:A) RETURN s, d",
    "MATCH (s:A)-[:x*0..]->(d) RETURN s, d",
]
VIEWS = [
    "CREATE VIEW V0 AS (CONSTRUCT (s)-[r:V0]->(d) "
    "MATCH (s:A)-[e:x]->(m:B)-[f:y]->(d))",                     # exact
    "CREATE VIEW V1 AS (CONSTRUCT (s)-[r:V1]->(d) "
    "MATCH (s:A)-[e:x*1..]->(d:B)) REFRESH DEFERRED",
    "CREATE VIEW V2 AS (CONSTRUCT (s)-[r:V2]->(d) "
    "MATCH (s:B)-[e:y]->(d) WHERE e.w >= 2) REFRESH STALENESS 2",
]
SERVE_QS = [
    "MATCH (a:A)-[e:x]->(m:B)-[f:y]->(c) RETURN a, c",
    "MATCH (a:A)-[e:x*1..2]->(d:B) WHERE a.age >= 3 RETURN a, d",
    "MATCH (a:A)-[e:x*1..]->(d:B) RETURN a, d",
    "MATCH (s:B)-[e:y]->(d) WHERE e.w >= 2 RETURN s, d",
]
# the serve scheduler's window adapts to wall-clock latency: pin it, so
# both runs make the same scheduling decisions
PIN = {"window_init": 64, "window_min": 64, "window_max": 64}


def build(pkg, shards=1, seed=0, n=18, p=0.15, edge_cap=2048):
    rng = np.random.default_rng(seed)
    schema = pkg.GraphSchema()
    b = pkg.GraphBuilder(schema)
    for _ in range(n):
        b.add_node(("A", "B")[int(rng.integers(2))],
                   props={"age": int(rng.integers(0, 8))})
    for u in range(n):
        for v in range(n):
            if u != v and rng.random() < p:
                b.add_edge(u, v, ("x", "y")[int(rng.integers(2))],
                           props={"w": int(rng.integers(0, 5))})
    if pkg is R:
        return R.GraphSession(b.finalize(edge_cap=edge_cap), schema)
    cfg = P.ExecConfig(data_shards=shards)
    return P.GraphSession(b.finalize(edge_cap=edge_cap, device="cpu"),
                          schema, cfg=cfg, device="cpu")


def snap(r):
    s, d, c = r.pairs()
    return (sorted(zip(s.tolist(), d.tolist(), c.tolist())),
            r.metrics.db_hits, r.metrics.rows)


_REF = {}


def reference(name, fn):
    """The reference's single-device answer, computed once per module."""
    if name not in _REF:
        _REF[name] = fn()
    return _REF[name]


# ---------------- PLAN_PARITY ---------------------------------------------

@pytest.mark.parametrize("shards", [2, 4, 8])
def test_plan_parity(shards):
    want = reference("plans", lambda: [snap(build(R).query(q))
                                       for q in QUERIES])
    sess = build(P, shards)
    assert sess.engine.shard_devices() == [torch.device("cpu")] * shards
    got = [snap(sess.query(q)) for q in QUERIES]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (shards, QUERIES[i])
    # every hop of a sharded plan is a segment hop over partitioned slices
    plan, _ = sess.planner.plan(P.parse_query(QUERIES[3]), [], 0)
    assert {s.backend for s in plan.steps if hasattr(s, "backend")} == {
        "segment"}
    assert any(k[3] == shards for k in sess.engine._shard_cache)


def test_sharded_reach_rows_are_the_unsharded_rows():
    """Reach rows (not only pairs) and per-row metric vectors of a batch
    equal the unsharded port's, pad columns sliced away."""
    one, four = build(P, 1), build(P, 4)
    for q in QUERIES:
        a = one.planner.plan(P.parse_query(q), [], 0)[0]
        b = four.planner.plan(P.parse_query(q), [], 0)[0]
        srcs = [a.default_sources(), np.arange(18, dtype=np.int32)]
        for ra, rb in zip(a.execute_rows(srcs), b.execute_rows(srcs)):
            assert rb.reach.shape == (ra.reach.shape[0], one.g.node_cap)
            np.testing.assert_array_equal(ra.reach, rb.reach, err_msg=q)
            np.testing.assert_array_equal(ra.db_vec, rb.db_vec, err_msg=q)
            np.testing.assert_array_equal(ra.rows_vec, rb.rows_vec,
                                          err_msg=q)


def test_sharded_closure_bound_raises_as_the_reference():
    """A closure cut short by ``max_closure_iters`` raises the reference's
    error sharded as unsharded."""
    q = "MATCH (s:A)-[e:x*1..]->(d:B) RETURN s, d"
    r = build(R)
    r.cfg.max_closure_iters = 1
    with pytest.raises(RuntimeError) as want:
        r.query(q)
    sess = build(P, 4)
    sess.cfg.max_closure_iters = 1
    with pytest.raises(RuntimeError) as got:
        sess.query(q)
    assert str(got.value) == str(want.value)


# ---------------- SERVE_PARITY and SWEEP_ROUTING --------------------------

def serve_script(pkg, seed, n):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(3):
        for q in SERVE_QS:
            ops.append(("read", q, None))
            src = np.asarray([int(rng.integers(n))], np.int32)
            ops.append(("read", q, src))
        u = int(rng.integers(n))
        fence = pkg.WriteBatch().create_edge(
            u, (u + 1) % n, "x", props={"w": int(rng.integers(5))})
        fence.set_node_prop(int(rng.integers(n)), "age",
                            int(rng.integers(8)))
        ops.append(("write", fence, None))
    ops.append(("read", SERVE_QS[0], None))
    return ops


def run_serve(pkg, shards=1):
    sess = build(pkg, shards, seed=3, n=14, p=0.22, edge_cap=512)
    for v in VIEWS:
        sess.create_view(v)
    eng = sess.serve((r_serve if pkg is R else p_serve).ServeConfig(**PIN))
    ops = serve_script(pkg, 11, 14)
    tickets = [eng.submit(payload, sources=src) if kind == "read"
               else eng.submit_writes(payload)
               for kind, payload, src in ops]
    stats = eng.run()
    out = [(t.result.src_ids.tolist(), np.asarray(t.result.reach).tolist(),
            t.result.metrics.db_hits, t.result.metrics.rows)
           for t, (kind, _, _) in zip(tickets, ops) if kind == "read"]
    sess.refresh()
    assert all(sess.check_consistency(v) for v in list(sess.views))
    lids = {v.label_id for v in sess.views.values()}
    return out, stats, dict(getattr(sess.engine, "shard_sweeps", {})), lids


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_serve_parity(shards):
    want, _, _, _ = reference("serve", lambda: run_serve(R))
    _, one, _, _ = reference("serve_port_1", lambda: run_serve(P, 1))
    got, st, _, _ = run_serve(P, shards)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (shards, i)
    assert st.shared_groups > 0
    assert st.shared_groups == one.shared_groups
    assert st.warm_pool_hits == one.warm_pool_hits


def test_sweeps_route_to_label_owners():
    _, _, sweeps, lids = run_serve(P, 4)
    assert sweeps and sum(sweeps.values()) > 0
    assert set(sweeps) <= {lid % 4 for lid in lids}
    assert len(sweeps) > 1, f"expected sweeps spread over owners: {sweeps}"
    _, _, none, _ = reference("serve_port_1", lambda: run_serve(P, 1))
    assert none == {}          # an unsharded session routes nothing


# ---------------- GROWTH_FENCE --------------------------------------------

def run_growth(pkg, shards=1):
    sess = build(pkg, shards, seed=5, n=10, p=0.3, edge_cap=4096)
    sess.create_view("CREATE VIEW VG AS (CONSTRUCT (s)-[r:VG]->(d) "
                     "MATCH (s:A)-[e:x]->(m:B)-[f:x]->(d))")
    out = [snap(sess.query(q)) for q in QUERIES[:3]]
    cap0 = sess.g.node_cap
    batch = pkg.WriteBatch()
    for i in range(cap0):            # forces the node arena to grow
        batch.create_node("A" if i % 2 else "B", props={"age": 3})
    res = sess.apply_writes(batch)
    assert sess.g.node_cap > cap0
    b2 = pkg.WriteBatch()
    for nid in res.node_slots[:6]:
        b2.create_edge(int(nid), int(res.node_slots[0]) if nid % 2 else 1,
                       "x", props={"w": 2})
    sess.apply_writes(b2)
    out += [snap(sess.query(q)) for q in QUERIES[:3]]
    return out, sess.g.node_cap, sess


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_growth_fence_repartitions(shards):
    want, cap_w, _ = reference("growth", lambda: run_growth(R))
    got, cap_g, sess = run_growth(P, shards)
    assert cap_g == cap_w and got == want
    # every live shard entry was partitioned at the grown capacity
    eng = sess.engine
    assert eng._shard_cache
    for (lid, _, _, _), (validity, ops) in eng._shard_cache.items():
        if validity == eng._shard_validity(lid):
            deg = ops[4]
            assert len(deg) == shards
            assert all(d.shape == (eng.node_pad(),) for d in deg)


# ---------------- the device list -----------------------------------------

def test_make_host_mesh_descriptive_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError) as ei:
        make_host_mesh(n_data=4)
    msg = str(ei.value)
    assert "4 devices" in msg and "are available" in msg
    assert "devices=" in msg


def test_make_host_mesh_rejects_short_device_list():
    with pytest.raises(ValueError, match="were passed"):
        make_host_mesh(n_data=2, n_model=2, devices=["cpu"])


def test_make_host_mesh_override_takes_the_first_n():
    grid = make_host_mesh(n_data=2, devices=["cpu", "cpu", "meta"])
    assert grid.shape == (2, 1)
    assert list(grid[:, 0]) == [torch.device("cpu")] * 2
    grid = make_host_mesh(n_data=3, devices=["cpu"] * 3)
    assert grid.shape == (3, 1)


def test_card_session_without_shard_devices_raises(monkeypatch):
    """An engine on the card with ``shard_devices=None`` takes the visible
    cards and raises when fewer exist than shards: nothing folds N shards
    onto one card unless the list says so."""
    sess = build(P, 1)
    eng = P.ExecEngine(sess.g, sess.schema, P.ExecConfig(data_shards=4))
    monkeypatch.setattr(type(eng), "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="are available"):
        eng.mesh()
    eng = P.ExecEngine(sess.g, sess.schema, P.ExecConfig(data_shards=4),
                       shard_devices=["cpu"] * 4)
    assert eng.shard_devices() == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="were passed"):
        P.GraphSession(sess.g, sess.schema, P.ExecConfig(data_shards=4),
                       device="cpu", shard_devices=["cpu"] * 3)


@pytest.mark.cuda
def test_cuda_session_shards_on_named_devices():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sess = build(P, 1)
    g = sess.g.to("cuda")
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="are available"):
        P.GraphSession(g, sess.schema, P.ExecConfig(data_shards=n + 1))
    on_one = P.GraphSession(g, sess.schema, P.ExecConfig(data_shards=4),
                            shard_devices=["cuda:0"] * 4)
    one = build(P, 1)
    for q in QUERIES:
        assert snap(on_one.query(q)) == snap(one.query(q)), q


# ---------------- unit cases against the reference ------------------------

@pytest.mark.parametrize("seed,n_pad,shards",
                         [(0, 64, 2), (1, 128, 4), (2, 96, 8), (3, 8, 8)])
def test_partition_hop_edges_matches_reference(seed, n_pad, shards):
    rng = np.random.default_rng(seed)
    E = int(rng.integers(0, 200))
    gather = rng.integers(0, n_pad, E).astype(np.int32)
    scatter = rng.integers(0, n_pad, E).astype(np.int32)
    w = rng.integers(1, 9, E).astype(np.int32)
    got = p_dist.partition_hop_edges(gather, scatter, w, n_pad, shards)
    want = r_dist.partition_hop_edges(gather, scatter, w, n_pad, shards)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[4].sum(0),
                                  np.bincount(gather, minlength=n_pad))
    with pytest.raises(ValueError):
        p_dist.partition_hop_edges(gather, scatter, w, n_pad + 1, 2)
    for pair in zip(p_dist.partition_edges_by_dst(scatter, gather, n_pad,
                                                  shards),
                    r_dist.partition_edges_by_dst(scatter, gather, n_pad,
                                                  shards)):
        np.testing.assert_array_equal(*pair)
    for lid in range(-1, 9):
        assert p_dist.shard_owner(lid, shards) == r_dist.shard_owner(
            lid, shards)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_owner_order_matches_reference(shards):
    rng = np.random.default_rng(shards)
    views = [SimpleNamespace(label_id=int(x), name=f"V{i}")
             for i, x in enumerate(rng.permutation(12))]
    got = [v.name for v in p_maint.owner_order(views, shards)]
    want = [v.name for v in r_maint.owner_order(views, shards)]
    assert got == want

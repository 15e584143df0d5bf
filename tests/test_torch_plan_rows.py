"""The serve path's plan parts == the reference, bit for bit.

Adaptive block sizing, ``RowResult.covers``/``gather``, the structure key
and share scales that bucket plans for cross-fingerprint sharing, the
row-parameterized hops (each row with its own edge operands), and
``SharedProgram.execute``: every row of a shared batch must equal its
plan's solo ``execute_rows`` and the reference's shared program, with
members that differ in label, predicate and direction, over bounded and
unbounded hop ranges.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as R
import repro.core.executor as r_ex
import repro.core.plan as r_plan
import repro_torch.core as P
import repro_torch.core.executor as p_ex
import repro_torch.core.plan as p_plan
from repro_torch.utils import host

# plans sharing a structure in groups: one hop (labels, direction and
# predicates differ), two hop ranges, closures, and both directions
QUERIES = [
    "MATCH (a:A)-[e:x]->(b) RETURN a, b",
    "MATCH (s:B)-[e:y]->(d) WHERE e.w >= 2 RETURN s, d",
    "MATCH (a:A)<-[e:x]-(b:B) RETURN a, b",
    "MATCH (a:B)-[e:x]->(b:A) WHERE b.age >= 3 RETURN a, b",
    "MATCH (a:A)-[e:x*1..2]->(d:B) WHERE a.age >= 3 RETURN a, d",
    "MATCH (a:B)<-[e:y*1..2]-(d) WHERE e.w <= 3 RETURN a, d",
    "MATCH (a:A)-[e:x*1..]->(d:B) RETURN a, d",
    "MATCH (a:B)<-[e:y*1..]-(d:A) WHERE e.w >= 1 RETURN a, d",
    "MATCH (a:A)-[e:x]-(b) RETURN a, b",
    "MATCH (a:B)-[e:y]-(b:A) WHERE e.w = 2 RETURN a, b",
    "MATCH (a:A)-[:x]->(m:B)-[:y]->(c) RETURN a, c",
]


def build(pkg, seed=0, n=20, cfg=None):
    rng = np.random.default_rng(seed)
    schema = pkg.GraphSchema()
    b = pkg.GraphBuilder(schema)
    for i in range(n):
        b.add_node(("A", "B")[i % 2], props={"age": int(rng.integers(0, 8))})
    for u in range(n):
        for v in range(n):
            if u != v and rng.random() < 0.2:
                b.add_edge(u, v, ("x", "y")[int(rng.integers(2))],
                           props={"w": int(rng.integers(0, 5))})
    kw = {"device": "cpu"} if pkg is P else {}
    return pkg.GraphSession(b.finalize(edge_cap=1024, **kw), schema, cfg,
                            **kw)


def plans(sess, pkg):
    return [sess.planner.plan(pkg.parse_query(q), [], 0)[0] for q in QUERIES]


def same_rows(a, b, ctx=""):
    np.testing.assert_array_equal(a.sources, b.sources, err_msg=ctx)
    np.testing.assert_array_equal(a.reach, b.reach, err_msg=ctx)
    np.testing.assert_array_equal(a.db_vec, b.db_vec, err_msg=ctx)
    np.testing.assert_array_equal(a.rows_vec, b.rows_vec, err_msg=ctx)
    assert a.counting == b.counting, ctx


@pytest.mark.parametrize("adaptive", [False, True])
def test_block_sizes_match_reference(adaptive):
    for blk in (8, 64, 256):
        for rows in range(601):
            assert p_plan.block_sizes(rows, blk, adaptive) == \
                r_plan.block_sizes(rows, blk, adaptive), (rows, blk)
    assert p_plan.block_sizes(5, 256, True) == [8]
    assert p_plan.block_sizes(200, 256, True) == [256]
    assert p_plan.block_sizes(257, 256, True) == [256, 256]


def test_row_result_covers_and_gather_match_reference():
    rng = np.random.default_rng(0)
    src = np.unique(rng.integers(0, 50, 20)).astype(np.int32)
    S = src.shape[0]
    reach = rng.integers(0, 4, (S, 50)).astype(np.int32)
    db, rows = rng.integers(0, 9, S), rng.integers(0, 9, S)
    rr_p = p_plan.RowResult(src, reach, db.astype(np.int64),
                            rows.astype(np.int64), True)
    rr_r = r_plan.RowResult(src, reach, db.astype(np.int32),
                            rows.astype(np.int32), True)
    empty = np.zeros(0, np.int32)
    probes = [src[:3], src[[4, 4, 1]], np.asarray([src[0], 51], np.int32),
              np.asarray([-1], np.int32), empty, src]
    for s in probes:
        assert rr_p.covers(s) == rr_r.covers(s), s
        if rr_r.covers(s):
            same_rows(rr_p.gather(s), rr_r.gather(s), str(s))
            rp = rr_p.gather(s).to_reach_result()
            rr = rr_r.gather(s).to_reach_result()
            assert (rp.metrics.db_hits, rp.metrics.rows) == \
                (rr.metrics.db_hits, rr.metrics.rows)
    none_p = p_plan.RowResult(empty, reach[:0], db[:0], rows[:0], False)
    none_r = r_plan.RowResult(empty, reach[:0], db[:0], rows[:0], False)
    for s in (empty, src[:1]):
        assert none_p.covers(s) == none_r.covers(s)


def test_structure_keys_and_scales_match_reference():
    ps, rs = build(P), build(R)
    for q, pp, rp in zip(QUERIES, plans(ps, P), plans(rs, R)):
        assert pp.structure_key() == rp.structure_key(), q
        assert pp.share_scales() == rp.share_scales(), q
        assert pp._nprop_pairs == rp._nprop_pairs, q
    dense = P.GraphSession(ps.g, ps.schema, P.ExecConfig(backend="dense"),
                           device="cpu")
    assert all(p.structure_key() is None for p in plans(dense, P))
    assert ps.planner.plan_calls == len(QUERIES)


@pytest.mark.parametrize("counting", [True, False])
def test_row_hops_match_homogeneous_and_reference(counting):
    rng = np.random.default_rng(1 + counting)
    blk, N, E = 6, 40, 90
    F_np = rng.integers(0, 3, (blk, N)).astype(np.int32)
    if not counting:
        F_np = F_np > 1
    esrc, edst = rng.integers(0, N, E), rng.integers(0, N, E)
    w = rng.integers(1, 4, E).astype(np.int32)
    mask = rng.random(E) < 0.8
    deg = rng.integers(0, 7, N).astype(np.int32)
    F = torch.from_numpy(F_np)
    t = {k: torch.from_numpy(v) for k, v in (("s", esrc), ("d", edst),
                                             ("w", w), ("m", mask),
                                             ("deg", deg))}
    rows = lambda x: x[None, :].expand(blk, -1).contiguous()   # noqa: E731
    for rev in (False, True):
        a, b = (t["d"], t["s"]) if rev else (t["s"], t["d"])
        got = p_ex._hop_segment_rows(F, rows(a), rows(b), rows(t["m"]),
                                     rows(t["w"]), counting=counting)
        want = p_ex._hop_segment(F, t["s"], t["d"], t["m"], t["w"],
                                 counting=counting, reverse=rev)
        assert torch.equal(got, want), rev
    assert torch.equal(p_ex._hop_cost_rows(F, rows(t["deg"])),
                       p_ex._hop_cost_per_source(F, t["deg"]))

    # heterogeneous rows: each row its own slice, against the reference
    S = rng.integers(0, N, (blk, E))
    D = rng.integers(0, N, (blk, E))
    W = rng.integers(1, 4, (blk, E)).astype(np.int32)
    M = rng.random((blk, E)) < 0.7
    DEG = rng.integers(0, 7, (blk, N)).astype(np.int32)
    got = p_ex._hop_segment_rows(F, torch.from_numpy(S), torch.from_numpy(D),
                                 torch.from_numpy(M), torch.from_numpy(W),
                                 counting=counting)
    want = r_ex._hop_segment_rows(jnp.asarray(F_np), jnp.asarray(S, jnp.int32),
                                  jnp.asarray(D, jnp.int32), jnp.asarray(M),
                                  jnp.asarray(W), counting=counting)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        p_ex._hop_cost_rows(F, torch.from_numpy(DEG)).numpy(),
        np.asarray(r_ex._hop_cost_rows(jnp.asarray(F_np), jnp.asarray(DEG))))


@pytest.mark.parametrize("adaptive", [True, False])
def test_shared_program_matches_solo_and_reference(adaptive):
    ps, rs = build(P, seed=3), build(R, seed=3)
    pp, rp = plans(ps, P), plans(rs, R)
    groups = {}
    for i, plan in enumerate(pp):
        if plan.structure_key() is not None:
            groups.setdefault(plan.structure_key(), []).append(i)
    # four one-hop members, three pairs, and the two-hop plan alone (padded
    # to two members)
    assert sorted(len(g) for g in groups.values()) == [1, 2, 2, 2, 4]
    rng = np.random.default_rng(4)
    for key, members in groups.items():
        specs = []
        for i in members:
            own = pp[i].default_sources()
            specs.append([own, np.asarray([int(rng.integers(20))], np.int32),
                          np.zeros(0, np.int32), own[:2]])
        got = ps.planner.shared_program(key).execute(
            [pp[i] for i in members], specs, adaptive_blocks=adaptive)
        want = rs.planner.shared_program(rp[members[0]].structure_key()) \
            .execute([rp[i] for i in members], specs,
                     adaptive_blocks=adaptive)
        assert ps.planner.shared_program(key) is \
            ps.planner.shared_program(key)
        for m, i in enumerate(members):
            solo = pp[i].execute_rows(specs[m], adaptive_blocks=adaptive)
            for j in range(len(specs[m])):
                ctx = f"{QUERIES[i]} binding {j}"
                same_rows(got[m][j], solo[j], ctx)
                same_rows(got[m][j], want[m][j], ctx)


# -- the batch pull's result -------------------------------------------------

COUNTING_READ = QUERIES[4]       # a finite hop range: walk counts, int32 F
SET_READ = QUERIES[6]            # an unbounded one: reachability, bool F


@pytest.mark.parametrize("backend", ["segment", "dense"])
@pytest.mark.parametrize("q", [COUNTING_READ, SET_READ])
def test_a_reads_rows_are_one_dense_int32_array(q, backend):
    """A read's ``reach`` is one C-contiguous ``[S, node_cap]`` array equal
    by value to the reference's int32 rows: int32 for a counting read, and
    for a set-semantics read its bool frontier as it is, one byte an
    entry."""
    ps = build(P, seed=5, cfg=P.ExecConfig(backend=backend))
    got, want = ps.query(q), build(R, seed=5).query(q)
    assert got.counting == (q == COUNTING_READ)
    assert got.reach.dtype == (np.int32 if got.counting else np.bool_)
    assert np.asarray(want.reach).dtype == np.int32
    assert got.reach.flags.c_contiguous
    assert got.reach.shape == (got.src_ids.shape[0], ps.g.node_cap)
    np.testing.assert_array_equal(got.src_ids, np.asarray(want.src_ids))
    np.testing.assert_array_equal(got.reach, np.asarray(want.reach))


def test_results_of_two_reads_share_no_memory():
    """Each read's rows are its own: two reads of one plan share no memory,
    and a result kept across later reads is unchanged by them."""
    ps = build(P, seed=6)
    kept = ps.query(COUNTING_READ)
    copy = kept.reach.copy()
    later = [ps.query(q) for q in (COUNTING_READ, SET_READ, COUNTING_READ)]
    for r in later:
        assert not np.shares_memory(kept.reach, r.reach)
    assert not np.shares_memory(later[0].reach, later[2].reach)
    np.testing.assert_array_equal(kept.reach, copy)
    plan = ps.planner.plan(P.parse_query(COUNTING_READ), [], 0)[0]
    a, b = plan.execute_rows([plan.default_sources()] * 2)
    assert not np.shares_memory(a.reach, b.reach)   # rows of one batch
    assert a.reach.flags.c_contiguous and b.reach.flags.c_contiguous


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_rows_pull_once_and_match(shards):
    """Sharded F carries pad columns; the batch is cut to ``node_cap``
    columns on the device and still pulled by one counted call, equal to
    the unsharded port's and the reference's rows."""
    one = build(P, seed=7)
    many = build(P, seed=7, cfg=P.ExecConfig(data_shards=shards))
    ref = build(R, seed=7)
    for q in (COUNTING_READ, SET_READ, QUERIES[10]):
        a = one.planner.plan(P.parse_query(q), [], 0)[0]
        b = many.planner.plan(P.parse_query(q), [], 0)[0]
        srcs = [a.default_sources(), np.arange(9, dtype=np.int32)]
        b.execute_rows(srcs)                               # warm the caches
        h0 = host.calls
        got = b.execute_rows(srcs)
        assert host.calls - h0 == 1, q
        want = ref.planner.plan(R.parse_query(q), [], 0)[0].execute_rows(srcs)
        for rp, ra, rr in zip(got, a.execute_rows(srcs), want):
            assert rp.reach.dtype == (np.int32 if rp.counting else np.bool_)
            assert np.asarray(rr.reach).dtype == np.int32
            assert rp.reach.flags.c_contiguous
            assert rp.reach.shape == (len(rp.sources), one.g.node_cap)
            same_rows(rp, ra, q)
            np.testing.assert_array_equal(rp.reach, np.asarray(rr.reach), q)

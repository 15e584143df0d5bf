"""One pull per batch: the compiled plans' device-to-host reads, counted.

The reference keeps every block's outputs on the device and pulls them once
per batch (``src/repro/core/plan.py``, "One host sync per batch").  The
port's ``CompiledPlan.execute_rows`` and ``SharedProgram.execute`` do the
same: one :func:`repro_torch.utils.host` call brings back the reach rows
and both metric vectors, whatever the block count.  An unbounded closure
reads its "frontier is empty" flag through ``host_flag`` after its first
iteration and then every ``CLOSURE_SYNC_EVERY`` iterations, never past
``max_closure_iters``: closures that stop exactly at the bound, or converge
on an iteration the stride does not land on, give the reference's rows and
metrics, and the reference's error when they do not converge.
"""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
import repro_torch.core.plan as p_plan
from repro_torch.utils import host, host_flag

# chains of these lengths, one after another: a closure from a chain's head
# takes (length - 1) steps to find an empty frontier
CHAINS = (2, 3, 5, 6, 9, 10, 13, 17)
STRIDES = [1, 2, 3, 5]


def chain_graph(pkg, chains=CHAINS, branch=True):
    schema = pkg.GraphSchema()
    b = pkg.GraphBuilder(schema)
    heads, nid = [], 0
    for length in chains:
        heads.append(nid)
        for i in range(length):
            b.add_node("A" if i % 2 == 0 else "B")
        for i in range(length - 1):
            b.add_edge(nid + i, nid + i + 1, "x")
            if branch and i + 2 < length:      # more than one path
                b.add_edge(nid + i, nid + i + 2, "x")
        nid += length
    kw = {"device": "cpu"} if pkg is P else {}
    return b.finalize(edge_cap=512, **kw), schema, np.asarray(heads, np.int32)


def session(pkg, **cfg):
    g, schema, heads = chain_graph(pkg)
    kw = {"device": "cpu"} if pkg is P else {}
    return pkg.GraphSession(g, schema, pkg.ExecConfig(**cfg), **kw), heads


def rows_of(rr):
    return (rr.reach.tolist(), rr.db_vec.tolist(), rr.rows_vec.tolist())


def counted(fn):
    """Run ``fn`` and return (its result, host() calls, host_flag() calls)."""
    h0, f0 = host.calls, host_flag.calls
    out = fn()
    return out, host.calls - h0, host_flag.calls - f0


@pytest.mark.parametrize("src_block", [8, 16, 64])
def test_execute_rows_pulls_once_per_batch(src_block):
    """Every node as a source, over 1 to 9 blocks, a closure of 15 steps
    and bounded counting hops: one pull a batch, equal to the reference."""
    sess, _ = session(P, src_block=src_block)
    ref, _ = session(R, src_block=src_block)
    n = sum(CHAINS)
    srcs = [np.arange(n, dtype=np.int32)[:n // 2],
            np.arange(n, dtype=np.int32)[n // 2:]]
    blocks = len(p_plan.block_sizes(n, src_block))
    for q in ("MATCH (s)-[:x*1..]->(d) RETURN s, d",
              "MATCH (s)-[:x*1..3]->(d:B) RETURN s, d",
              "MATCH (s:A)-[:x]->(m)-[:x*0..]->(d) RETURN s, d"):
        plan = sess.planner.plan(P.parse_query(q), [], 0)[0]
        rplan = ref.planner.plan(R.parse_query(q), [], 0)[0]
        plan.execute_rows(srcs)                       # warm the caches
        got, pulls, flags = counted(lambda: plan.execute_rows(srcs))
        want = rplan.execute_rows(srcs)
        assert pulls == 1, (q, blocks, pulls)
        assert [rows_of(r) for r in got] == [rows_of(r) for r in want], q
        if "*1..3" in q:
            assert flags == 0
        else:
            # at least one read a block, fewer than one a hop
            assert blocks <= flags < blocks * max(CHAINS), (q, flags)
    assert blocks >= 3 or src_block == 64


def test_shared_program_pulls_once_per_batch():
    """A shared batch of two member plans over three blocks: one pull."""
    sess, heads = session(P, src_block=8)
    qs = ("MATCH (s:A)-[:x*1..]->(d) RETURN s, d",
          "MATCH (s:B)-[:x*1..]->(d) RETURN s, d")
    plans = [sess.planner.plan(P.parse_query(q), [], 0)[0] for q in qs]
    key = plans[0].structure_key()
    assert key == plans[1].structure_key()
    shared = sess.planner.shared_program(key)
    specs = [[np.arange(0, 40, dtype=np.int32)],
             [np.arange(20, 60, dtype=np.int32)]]
    want = [p.execute_rows(s) for p, s in zip(plans, specs)]
    shared.execute(plans, specs, adaptive_blocks=False)     # warm
    got, pulls, _ = counted(lambda: shared.execute(plans, specs,
                                                   adaptive_blocks=False))
    assert pulls == 1
    assert [[rows_of(r) for r in m] for m in got] == \
        [[rows_of(r) for r in m] for m in want]


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("max_iters", [1, 4, 8, 9, 12, 16, 20])
def test_closure_bound_and_stride_match_reference(monkeypatch, stride,
                                                  max_iters):
    """Each chain head alone: closures that converge before, exactly at and
    after ``max_closure_iters``, under strides that land on the converging
    iteration or pass it, give the reference's rows and metrics or its
    error."""
    monkeypatch.setattr(p_plan, "CLOSURE_SYNC_EVERY", stride)
    sess, heads = session(P, max_closure_iters=max_iters)
    ref, _ = session(R, max_closure_iters=max_iters)
    for q in ("MATCH (s)-[:x*1..]->(d) RETURN s, d",
              "MATCH (s:A)-[:x*2..]->(d:A) RETURN s, d"):
        for h in heads:
            try:
                want = ref.query(q, sources=np.asarray([h], np.int32))
            except RuntimeError as exc:
                with pytest.raises(RuntimeError) as got:
                    sess.query(q, sources=np.asarray([h], np.int32))
                assert str(got.value) == str(exc)
                continue
            got = sess.query(q, sources=np.asarray([h], np.int32))
            np.testing.assert_array_equal(got.reach, want.reach)
            assert (got.metrics.db_hits, got.metrics.rows) == \
                (want.metrics.db_hits, want.metrics.rows), (q, h)


def test_closure_never_hops_past_the_bound(monkeypatch):
    """The last stride is cut at ``max_closure_iters``: a chain of 17 under
    ``max_closure_iters=16`` converges on the bound's last iteration and no
    more hops run than the bound allows."""
    monkeypatch.setattr(p_plan, "CLOSURE_SYNC_EVERY", 8)
    hops = []
    real = p_plan._hop_segment

    def counting_hop(*a, **k):
        hops.append(1)
        return real(*a, **k)

    monkeypatch.setattr(p_plan, "_hop_segment", counting_hop)
    g, schema, heads = chain_graph(P, chains=(17,), branch=False)
    sess = P.GraphSession(g, schema, P.ExecConfig(max_closure_iters=16),
                          device="cpu")
    plan = sess.planner.plan(P.parse_query(
        "MATCH (s)-[:x*1..]->(d) RETURN s, d"), [], 0)[0]
    (rr,), _, flags = counted(lambda: plan.execute_rows([heads]))
    assert rr.reach[0].sum() == 16 and len(hops) == 1 + 16
    assert flags == 3             # after iterations 1, 9 and 16


def test_writes_run_no_compiled_plan(monkeypatch):
    """Maintenance runs the unfused executor (the reference's host-synced
    baseline), so a write never reaches the batch pull: CE, DE and DV on
    a session with exact views execute no compiled plan."""
    sess, heads = session(P)
    sess.create_view("CREATE VIEW V AS (CONSTRUCT (s)-[r:V]->(d) "
                     "MATCH (s:A)-[:x*1..2]->(d:A))")
    runs = []
    real = p_plan.CompiledPlan.execute_rows

    def counting(self, *a, **k):
        runs.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(p_plan.CompiledPlan, "execute_rows", counting)
    slot = sess.create_edge(int(heads[3]), int(heads[4]), "x")
    sess.delete_edge(slot)
    sess.delete_node(int(heads[5]) + 1)
    assert runs == [] and sess.check_consistency("V")

"""Port serve engine vs reference serve engine, ticket by ticket.

The differential cases of ``tests/test_serve.py`` run on both packages from
one seeded builder: every ticket's rows, source ids and DBHit/Rows must be
equal to the reference's (exact: they are integers).  Where a case is about
scheduler decisions (``via``, ``window``, ``window_seq``, ``hoisted``, the
``ServeStats`` counters), the admission window is pinned
(``window_init = window_min = window_max``), because the adaptive window
halves on wall-clock latency spikes and so may differ from run to run; those
decisions are then compared with the reference's as well.  The headline
mixed workload also leaves the window free and compares answers only, with
the reference and with the port's own sequential replay.
"""
import asyncio
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.serve import engine as r_serve
from repro_torch.serve import engine as p_serve

SERVE = {P: p_serve, R: r_serve}
PIN = {"window_init": 64, "window_min": 64, "window_max": 64}

QUERIES = [
    "MATCH (a:A)-[e:x]->(m:B)-[f:y]->(c) RETURN a, c",
    "MATCH (a:A)-[e:x*1..2]->(d:B) WHERE a.age >= 3 RETURN a, d",
    "MATCH (a:A)-[e:x*1..]->(d:B) RETURN a, d",      # unbounded: set semantics
    "MATCH (s:B)-[e:y]->(d) WHERE e.w >= 2 RETURN s, d",
]
VIEW = ("CREATE VIEW V0 AS (CONSTRUCT (s)-[r:V0]->(d) "
        "MATCH (s:A)-[e:x]->(m:B)-[f:y]->(d))")
VIEW_DEFERRED = VIEW + " REFRESH DEFERRED"
VIEW_BOUNDED = VIEW + " REFRESH STALENESS 10"


def build(pkg, seed=0, n=14, cfg=None):
    """The reference test's deterministic random graph, in either package."""
    rng = np.random.default_rng(seed)
    schema = pkg.GraphSchema()
    b = pkg.GraphBuilder(schema)
    for i in range(n):
        b.add_node(("A", "B")[i % 2], props={"age": int(rng.integers(0, 8))})
    for u in range(n):
        for v in range(n):
            if u != v and rng.random() < 0.22:
                b.add_edge(u, v, ("x", "y")[int(rng.integers(2))],
                           props={"w": int(rng.integers(0, 5))})
    kw = {"device": "cpu"} if pkg is P else {}
    return pkg.GraphSession(b.finalize(edge_cap=512, **kw), schema, cfg, **kw)


def serve(pkg, sess, **kw):
    return sess.serve(SERVE[pkg].ServeConfig(**kw))


def pkgs(scenario, *args):
    """``scenario(pkg, *args)`` on the port and on the reference."""
    return scenario(P, *args), scenario(R, *args)


def same_result(got, want, ctx=""):
    np.testing.assert_array_equal(got.src_ids, want.src_ids, err_msg=ctx)
    np.testing.assert_array_equal(got.reach, want.reach, err_msg=ctx)
    assert got.counting == want.counting, ctx
    assert (got.metrics.db_hits, got.metrics.rows) == \
        (want.metrics.db_hits, want.metrics.rows), ctx


def same_tickets(tp, tr, decisions=True):
    assert len(tp) == len(tr)
    for p, r in zip(tp, tr):
        ctx = f"uid={r.uid} kind={r.kind}"
        assert (p.uid, p.kind, p.done) == (r.uid, r.kind, r.done), ctx
        if r.kind == "read":
            same_result(p.result, r.result, ctx)
        elif r.kind == "write":
            np.testing.assert_array_equal(p.write_result.edge_slots,
                                          r.write_result.edge_slots, ctx)
            np.testing.assert_array_equal(p.write_result.node_slots,
                                          r.write_result.node_slots, ctx)
            assert p.scope.global_ == r.scope.global_, ctx
            assert p.scope.deferred_views == r.scope.deferred_views, ctx
        else:
            e, f = p.embed_result, r.embed_result
            np.testing.assert_array_equal(e.embeddings, f.embeddings, ctx)
            assert (e.view, e.version) == (f.view, f.version), ctx
        if decisions:
            assert (p.via, p.window, p.window_seq, p.hoisted, p.admit_by) == \
                (r.via, r.window, r.window_seq, r.hoisted, r.admit_by), ctx


def same_stats(sp, sr):
    assert dataclasses.asdict(sp) == dataclasses.asdict(sr)


def submit_ops(eng, ops):
    return [eng.submit(p, sources=s) if kind == "read"
            else eng.submit_writes(p) for kind, p, s in ops]


def mixed_ops(pkg, n_nodes=14):
    """Reads (full + per-client bindings) and fences, from one seed."""
    rng = np.random.default_rng(7)
    ops = []
    for _ in range(3):
        for q in QUERIES:
            ops.append(("read", q, None))
            for _ in range(3):  # point clients sharing the fingerprint
                src = np.asarray([int(rng.integers(n_nodes))], np.int32)
                ops.append(("read", q, src))
        u, v = int(rng.integers(n_nodes)), int(rng.integers(n_nodes))
        fence = pkg.WriteBatch().create_edge(
            u, max((u + 1) % n_nodes, 0), "x",
            props={"w": int(rng.integers(5))})
        fence.set_node_prop(v, "age", int(rng.integers(8)))
        ops.append(("write", fence, None))
    ops.append(("read", QUERIES[0], None))
    return ops


@pytest.mark.parametrize("pinned", [True, False], ids=["pinned", "free"])
def test_mixed_workload_matches_reference_and_sequential(pinned):
    def run(pkg):
        sess = build(pkg)
        sess.create_view(VIEW)
        eng = serve(pkg, sess, **(PIN if pinned else {}))
        ops = mixed_ops(pkg)
        tickets = submit_ops(eng, ops)
        eng.run()
        for v in sess.views:
            assert sess.check_consistency(v)
        return eng, tickets, ops

    (ep, tp, ops), (er, tr, _) = pkgs(run)
    same_tickets(tp, tr, decisions=pinned)
    if pinned:
        same_stats(ep.stats, er.stats)
    assert ep.stats.windows == 4 and ep.stats.write_batches == 3
    assert ep.stats.executions < ep.stats.queries
    twin = build(P)                   # the port's own sequential replay
    twin.create_view(VIEW)
    for t, (kind, payload, src) in zip(tp, ops):
        if kind == "read":
            same_result(t.result, twin.query(payload, sources=src),
                        f"sequential uid={t.uid}")
        else:
            twin.apply_writes(payload)


def test_fence_between_windows_and_arena_growth():
    def fence(pkg):
        sess = build(pkg, seed=3)
        eng = serve(pkg, sess, **PIN)
        before = [eng.submit(QUERIES[0]) for _ in range(8)]
        w = eng.submit_writes(pkg.WriteBatch()
                              .create_edge(0, 1, "x", props={"w": 4})
                              .create_edge(1, 2, "y", props={"w": 4}))
        after = [eng.submit(QUERIES[0]) for _ in range(8)]
        eng.run()
        return eng, before + [w] + after

    (ep, tp), (er, tr) = pkgs(fence)
    same_tickets(tp, tr)
    same_stats(ep.stats, er.stats)
    assert {t.window for t in tp[:8]} == {0} and {t.window for t in tp[9:]} == {1}
    assert not np.array_equal(tp[0].result.reach, tp[-1].result.reach)

    def grow(pkg):
        sess = build(pkg, seed=5)
        cap0 = sess.g.node_cap
        free = int((~np.asarray(sess.g.node_alive)).sum())
        batch = pkg.WriteBatch()
        for i in range(free + 8):       # exceed the free slots: growth
            batch.create_node(("A", "B")[i % 2], props={"age": i % 8})
        eng = serve(pkg, sess, **PIN)
        tickets = [eng.submit(QUERIES[0]), eng.submit_writes(batch)]
        tickets += [eng.submit(QUERIES[0]) for _ in range(4)]
        reset0 = sess.engine.epochs.reset_generation
        misses0 = sess.planner.plan_misses
        eng.run()
        assert sess.g.node_cap > cap0
        assert sess.engine.epochs.reset_generation > reset0
        assert sess.planner.plan_misses > misses0
        return eng, tickets

    (ep, tp), (er, tr) = pkgs(grow)
    same_tickets(tp, tr)
    same_stats(ep.stats, er.stats)


def test_groups_execute_once_and_point_clients_share_blocks():
    def run(pkg):
        sess = build(pkg, seed=1)
        eng = serve(pkg, sess, **PIN)
        same = [eng.submit(QUERIES[0]) for _ in range(32)]
        eng.run()
        assert (eng.stats.queries, eng.stats.groups,
                eng.stats.executions) == (32, 1, 1)
        eng2 = serve(pkg, build(pkg, seed=2), **PIN)
        clients = [eng2.submit(QUERIES[1], sources=np.asarray([i], np.int32))
                   for i in range(0, 14, 2)]
        eng2.run()
        assert eng2.stats.blocks == 1 and eng2.stats.executions == 7
        return (eng.stats, eng2.stats), same + clients

    (sp, tp), (sr, tr) = pkgs(run)
    same_tickets(tp, tr)
    for a, b in zip(sp, sr):
        same_stats(a, b)


def test_disjoint_label_fence_does_not_serialize():
    def run(pkg, label):
        sess = build(pkg, seed=6)
        eng = serve(pkg, sess, **PIN)
        pre = [eng.submit(QUERIES[3]) for _ in range(4)]
        w = eng.submit_writes(pkg.WriteBatch().create_edge(
            0, 1, label, props={"w": 4}))
        post = [eng.submit(QUERIES[3]) for _ in range(4)]
        eng.run()
        return eng, pre + [w] + post

    # a fence on x hoists the y reads behind it; the control on y splits
    for label, windows, hoisted in (("x", 1, 4), ("y", 2, 0)):
        (ep, tp), (er, tr) = pkgs(run, label)
        same_tickets(tp, tr)
        same_stats(ep.stats, er.stats)
        assert (ep.stats.windows, ep.stats.hoisted) == (windows, hoisted)


def test_deadline_order_and_no_starvation():
    def adversarial(pkg):
        sess = build(pkg, seed=7)
        eng = serve(pkg, sess, window_init=4, window_min=4, window_max=4)
        lax = [eng.submit(QUERIES[3], sources=np.asarray([i], np.int32),
                          deadline=50) for i in range(8)]
        urgent = [eng.submit(QUERIES[3],
                             sources=np.asarray([i + 3], np.int32),
                             deadline=0) for i in range(4)]
        eng.run()
        assert all(t.window_seq == 0 for t in urgent)
        assert eng.stats.deadline_misses == 0
        return eng, lax + urgent

    (ep, tp), (er, tr) = pkgs(adversarial)
    same_tickets(tp, tr)
    same_stats(ep.stats, er.stats)

    def flood(pkg):
        sess = build(pkg, seed=8)
        eng = serve(pkg, sess, window_init=4, window_min=4, window_max=4)
        old = [eng.submit(QUERIES[1], sources=np.asarray([i], np.int32))
               for i in range(8)]
        assert eng.step()
        hot = [eng.submit(QUERIES[3], sources=np.asarray([i], np.int32))
               for i in range(12)]
        eng.run()
        assert all(t.window_seq <= 1 for t in old)
        return eng, old + hot

    (ep, tp), (er, tr) = pkgs(flood)
    same_tickets(tp, tr)
    same_stats(ep.stats, er.stats)


def test_structural_sharing_and_occupancy():
    q_x = "MATCH (a:A)-[e:x]->(b) RETURN a, b"
    q_y = "MATCH (s:B)-[e:y]->(d) RETURN s, d"

    def sharing(pkg):
        sess = build(pkg, seed=9)
        eng = serve(pkg, sess, **PIN)
        tickets = [eng.submit(q_x)] + [
            eng.submit(q_x, sources=np.asarray([i], np.int32))
            for i in (0, 2, 4)]
        tickets += [eng.submit(q_y)] + [
            eng.submit(q_y, sources=np.asarray([i], np.int32))
            for i in (1, 3, 5)]
        eng.run()
        assert eng.stats.groups == 2 and eng.stats.shared_groups == 2
        for i, t in enumerate(tickets):    # against solo execution
            q = q_x if i < 4 else q_y
            same_result(t.result, sess.query(q, sources=t.sources))
        return eng, tickets

    (ep, tp), (er, tr) = pkgs(sharing)
    same_tickets(tp, tr)
    same_stats(ep.stats, er.stats)

    def occupancy(pkg):
        sess = build(pkg, seed=10)
        eng = serve(pkg, sess, **PIN)
        tickets = [eng.submit(QUERIES[3]) for _ in range(16)]
        eng.run()
        eng2 = serve(pkg, sess, **PIN)
        tickets += [eng2.submit(QUERIES[3], sources=np.asarray([i], np.int32))
                    for i in range(5)]
        eng2.run()
        assert eng2.stats.block_sizes == [8] and eng2.stats.occupancy == 5 / 8
        return (eng.stats, eng2.stats), tickets

    (sp, tp), (sr, tr) = pkgs(occupancy)
    same_tickets(tp, tr)
    for a, b in zip(sp, sr):
        same_stats(a, b)
    assert sp[0].rows == tp[0].result.src_ids.size and sp[0].executions == 1


def test_async_submit_await_and_poll():
    def run(pkg):
        sess = build(pkg, seed=11)
        eng = serve(pkg, sess, **PIN)

        async def client(q):
            return await eng.submit(q)

        async def main():
            return await asyncio.gather(client(QUERIES[0]),
                                        client(QUERIES[3]), eng.drain())

        r0, r3, stats = asyncio.run(main())
        assert stats.queries == 2
        eng2 = serve(pkg, sess, **PIN)
        t1, t2 = eng2.submit(QUERIES[0]), eng2.submit(QUERIES[3])
        assert not eng2.poll(t2)
        r = eng2.result(t2)           # pumps the scheduler
        assert eng2.poll(t2) and eng2.poll(t1)
        return (r0, r3, r), (t1, t2)

    (rp, tp), (rr, tr) = pkgs(run)
    for a, b in zip(rp, rr):
        same_result(a, b)
    same_tickets(tp, tr)


def test_views_on_and_off_are_separate_groups():
    def run(pkg):
        sess = build(pkg, seed=4)
        sess.create_view(VIEW)
        eng = serve(pkg, sess, **PIN)
        tickets = [eng.submit(QUERIES[0], use_views=True),
                   eng.submit(QUERIES[0], use_views=False)]
        eng.run()
        assert eng.stats.groups == 2
        np.testing.assert_array_equal(tickets[0].result.reach,
                                      tickets[1].result.reach)
        return eng, tickets

    (ep, tp), (er, tr) = pkgs(run)
    same_tickets(tp, tr)
    same_stats(ep.stats, er.stats)


def test_node_prop_fence_scopes():
    def run(pkg, node):
        sess = build(pkg, seed=11)
        eng = serve(pkg, sess, **PIN)
        pre = [eng.submit(QUERIES[1]) for _ in range(3)]
        # node 1 is a B node, node 0 an A node: only (A, age) conflicts
        w = eng.submit_writes(pkg.WriteBatch().set_node_prop(node, "age", 7))
        post = [eng.submit(QUERIES[1]) for _ in range(3)]
        eng.run()
        return eng, pre + [w] + post

    for node, windows in ((1, 1), (0, 2)):
        (ep, tp), (er, tr) = pkgs(run, node)
        same_tickets(tp, tr)
        same_stats(ep.stats, er.stats)
        assert ep.stats.windows == windows, node

    def dead(pkg):
        sess = build(pkg, seed=12)
        eng = serve(pkg, sess, **PIN)
        d = eng.submit_writes(pkg.WriteBatch(node_deletes=[2]))
        f = eng.submit_writes(pkg.WriteBatch().set_node_prop(2, "age", 5))
        t = eng.submit(QUERIES[1])
        assert d.scope.global_ and f.scope.global_
        eng.run()
        return eng, [d, f, t]

    (ep, tp), (er, tr) = pkgs(dead)
    same_tickets(tp, tr)
    same_stats(ep.stats, er.stats)


def stale_names(sess):
    return [h.name for h in sess.catalog() if h.is_stale]


def test_deferred_and_bounded_stale_freshness_gates():
    def blocks_then_drains(pkg):
        sess = build(pkg, seed=13)
        sess.create_view(VIEW_DEFERRED)
        eng = serve(pkg, sess, **PIN)
        f = eng.submit_writes(pkg.WriteBatch().create_edge(
            0, 3, "x", props={"w": 1}))
        assert f.scope.deferred_views == frozenset({"V0"})
        t = eng.submit(QUERIES[0], use_views=True)
        eng.run()
        assert not t.hoisted and eng.stats.drains >= 1
        assert stale_names(sess) == [] and sess.check_consistency("V0")
        return eng, [f, t]

    def view_free_hoists(pkg):
        sess = build(pkg, seed=13)
        sess.create_view(VIEW_DEFERRED)
        eng = serve(pkg, sess, **PIN)
        f = eng.submit_writes(pkg.WriteBatch().create_edge(
            0, 3, "y", props={"w": 1}))
        t = eng.submit(QUERIES[1])    # x-only plan, V0 cannot splice
        eng.run()
        assert t.hoisted and eng.stats.drains == 0
        assert stale_names(sess) == ["V0"]
        return eng, [f, t]

    def bounded(pkg):
        sess = build(pkg, seed=14)
        sess.create_view(VIEW_BOUNDED)
        pre = sess.query(QUERIES[0], use_views=True)
        eng = serve(pkg, sess, **PIN)
        f = eng.submit_writes(pkg.WriteBatch().create_edge(
            0, 3, "x", props={"w": 1}))
        t = eng.submit(QUERIES[0], use_views=True)
        eng.run()
        assert t.hoisted and eng.stats.drains == 0
        assert stale_names(sess) == ["V0"]
        same_result(t.result, pre)
        sess.refresh()
        assert sess.check_consistency("V0")
        return eng, [f, t]

    for scenario in (blocks_then_drains, view_free_hoists, bounded):
        (ep, tp), (er, tr) = pkgs(scenario)
        same_tickets(tp, tr)
        same_stats(ep.stats, er.stats)


def test_view_churn_under_traffic():
    def run(pkg):
        sess = build(pkg, seed=5)
        eng = serve(pkg, sess, **PIN)
        tickets = []

        def phase():
            for _ in range(2):           # repeats exercise memo reuse
                for q in QUERIES:
                    tickets.append(eng.submit(q))
                    tickets.append(eng.submit(q, sources=np.asarray(
                        [2], np.int32)))
            eng.run()

        phase()
        gen_before = eng._bucket_pool_gen
        sess.create_view(VIEW)
        phase()
        assert eng._bucket_pool_gen == sess.view_set_generation != gen_before
        sess.drop_view("V0")
        phase()
        tickets.append(eng.submit(QUERIES[0]))
        eng.run()
        sess.create_view(VIEW)
        tickets.append(eng.submit(QUERIES[0]))
        eng.run()
        assert eng._bucket_pool_gen == sess.view_set_generation
        return eng, tickets

    (ep, tp), (er, tr) = pkgs(run)
    same_tickets(tp, tr)
    same_stats(ep.stats, er.stats)


class PairEmbedder:
    """A duck-typed embedding operator over a view: a node's embedding is
    its summed out- and in-weight among the view's edges.  ``refresh``
    drains the view and re-embeds when its edges changed."""

    def __init__(self, sess, view_name):
        self.sess = sess
        self.view_name = view_name
        self.version = 0
        self._edges = None

    def refresh(self) -> bool:
        self.sess.refresh(self.view_name)
        weight = np.asarray(self.sess.g.edge_weight)
        edges = sorted((s, d, int(weight[slot])) for (s, d), slot in
                       self.sess.views[self.view_name].pair_slot.items())
        if edges == self._edges:
            return False
        self._edges = edges
        self.version += 1
        return True

    def lookup(self, ids):
        out = np.zeros((len(ids), 2), np.float32)
        for i, n in enumerate(np.asarray(ids)):
            out[i, 0] = sum(w for s, _, w in self._edges if s == n)
            out[i, 1] = sum(w for _, d, w in self._edges if d == n)
        return out


def test_embed_reads_order_behind_conflicting_fences():
    ids = np.arange(14)

    def run(pkg):
        sess = build(pkg, seed=4)
        sess.create_view(VIEW)
        eng = serve(pkg, sess, **PIN)
        assert eng.register_embedder(PairEmbedder(sess, "V0")) == "V0"
        pre = eng.submit_embed("V0", ids)
        # an x edge from an A node feeds V0: the second lookup waits for it
        w = eng.submit_writes(pkg.WriteBatch().create_edge(
            0, 1, "x", props={"w": 1}))
        post = eng.submit_embed("V0", ids)
        # a z edge touches no view: the third lookup hoists past it
        z = eng.submit_writes(pkg.WriteBatch().create_edge(
            2, 3, "z", props={"w": 1}))
        hoist = eng.submit_embed("V0", ids)
        eng.run()
        assert post.embed_result.version > pre.embed_result.version
        assert hoist.hoisted and not post.hoisted
        assert eng.result(pre) is pre.embed_result
        with pytest.raises(ValueError):
            eng.submit_embed("nope", ids)
        return eng, [pre, w, post, z, hoist]

    (ep, tp), (er, tr) = pkgs(run)
    same_tickets(tp, tr)
    same_stats(ep.stats, er.stats)
    assert ep.stats.embed_reads == 3


def test_dense_kernel_serve_group_matches_pallas():
    """A serve group whose hops run dense: ``block_spmm`` on the port
    (its plain version here, on CPU tensors), the Pallas kernel in
    interpret mode on the reference.  Point clients without their unbound
    read pack into an 8-row adaptive block."""
    cfgs = {P: P.ExecConfig(backend="dense", use_kernel=True),
            R: R.ExecConfig(backend="dense", use_pallas=True, interpret=True)}

    def run(pkg):
        sess = build(pkg, seed=2, cfg=cfgs[pkg])
        eng = serve(pkg, sess, **PIN)
        tickets = [eng.submit(QUERIES[1], sources=np.asarray([i], np.int32))
                   for i in range(0, 10, 2)]
        tickets.append(eng.submit(QUERIES[2]))
        tickets.append(eng.submit_writes(pkg.WriteBatch().create_edge(
            0, 5, "x", props={"w": 3})))
        tickets.append(eng.submit(QUERIES[2]))
        eng.run()
        assert 8 in eng.stats.block_sizes
        assert all(p.structure_key() is None
                   for p in sess.planner._plans.values())
        return eng, tickets

    (ep, tp), (er, tr) = pkgs(run)
    same_tickets(tp, tr)
    same_stats(ep.stats, er.stats)

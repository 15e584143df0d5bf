"""Port view selection and online selection == the reference.

Offline: the candidate subpaths, the Eq. 1 scores of every greedy pick and
the selected ``ViewDef`` s (offline executor path and the session's fused
stats store, maintenance-aware scoring included) must be equal on the same
seeded graph.  ``create_view(precomputed=)`` must install the pairs the
reference installs, and fall back to a fresh build once a write stales the
measurement.  Online: the cases of ``tests/test_online_selection.py`` run
on both packages with the admission window pinned (the selector evaluates
between windows, so window composition decides when it runs); the created
and dropped views, the selector's ``actions`` and every read must be equal.
Everything compared is an integer or derived from integers: exact.
"""
import numpy as np
import pytest

import repro.core as R
import repro.core.selection as r_sel
import repro_torch.core as P
import repro_torch.core.selection as p_sel
from repro.core import online_selection as r_online
from repro.data import synthetic as r_syn
from repro.serve import engine as r_serve
from repro_torch.configs.mv4pg import SNB_WORKLOAD
from repro_torch.core import online_selection as p_online
from repro_torch.data import synthetic as p_syn
from repro_torch.serve import engine as p_serve

MOD = {P: (p_sel, p_online, p_serve, p_syn),
       R: (r_sel, r_online, r_serve, r_syn)}
PIN = {"window_init": 64, "window_min": 64, "window_max": 64}

HOT = "MATCH (c:Comment)-[:replyOf*..]->(p:Post) RETURN c, p"
HOT2 = "MATCH (a:Person)-[:knows]->(m:Person)-[:knows]->(b:Person) RETURN a, b"
COLD = "MATCH (p:Person)-[:livesIn]->(pl:Place) RETURN p, pl"
READS = [HOT,
         "MATCH (c:Comment)-[:replyOf*..]->(p:Post)-[:hasTag]->(t:Tag) "
         "RETURN c, t",
         HOT2]


def snb(pkg, **sizes):
    kw = {"device": "cpu"} if pkg is P else {}
    g, schema, _ = MOD[pkg][3].snb_like(seed=0, **sizes, **kw)
    return g, schema


def session(pkg, sizes, **kw):
    g, schema = snb(pkg, **sizes)
    if pkg is P:
        kw["device"] = "cpu"
    return pkg.GraphSession(g, schema, **kw)


SMALL = dict(n_person=120, n_post=90, n_comment=400, n_place=12, n_tag=24)


def cands(cs):
    return [(repr(c.vdef), c.opt_eff, c.n_matches, c.db_hit_no_v, c.e_vl,
             c.maint_cost) for c in cs]


def test_candidate_subpaths_match_reference():
    reads = list(SNB_WORKLOAD.reads) + [
        "MATCH (a:Person)-[:knows]->(m:Person {id: 4})-[:knows]->(b) "
        "RETURN a, b",
        "MATCH (a:Person)-[r:knows]->(m:Person)-[:knows*1..3]->(b) "
        "WHERE m.age >= 2 RETURN a, r, b",
    ]
    got = p_sel.candidate_subpaths([P.parse_query(q) for q in reads])
    want = r_sel.candidate_subpaths([R.parse_query(q) for q in reads])
    assert [repr(s) for s in got] == [repr(s) for s in want]
    assert len(got) >= 6


def test_select_views_matches_reference():
    picks = {}
    for pkg in (P, R):
        sel = MOD[pkg][0]
        g, schema = snb(pkg, **SMALL)
        offline = sel.select_views(g, schema, READS, k=2)
        sess = session(pkg, SMALL)
        deferred = pkg.parse_view(
            "CREATE VIEW X AS (CONSTRUCT (a)-[r:X]->(b) MATCH (a:A)-[:x]->"
            "(b:B)) REFRESH DEFERRED").refresh
        fused = sess.select_views(READS + list(SNB_WORKLOAD.reads), k=3,
                                  refresh=deferred, write_fraction=0.5)
        stats = sess.selection_stats()
        scored = sel.greedy_select(
            stats, [pkg.parse_query(q) for q in READS], schema=sess.schema,
            k=4, write_fraction=0.25, weights=[3.0, 1.0, 2.0])
        picks[pkg] = ([repr(v) for v in offline], [repr(v) for v in fused],
                      cands(scored), stats.measures, stats.measure_hits)
    assert picks[P] == picks[R]
    offline, fused, scored, measures, hits = picks[P]
    assert 1 <= len(offline) <= 2 and fused and scored
    assert all("deferred" in v for v in fused)
    assert hits > 0, "the second greedy run must re-rank from memo hits"


def test_selected_views_reduce_db_hits_on_the_port():
    g, schema = snb(P, **SMALL)
    chosen = p_sel.select_views(g, schema, READS, k=2)
    sess = P.GraphSession(g, schema, device="cpu")
    base = {q: sess.query(q, use_views=False).metrics.db_hits for q in READS}
    for vdef in chosen:
        sess.create_view(vdef)
    assert sum(sess.query(q).metrics.db_hits < base[q] for q in READS) >= 2
    comments = np.flatnonzero(np.asarray(sess.g.node_label)
                              == schema.node_labels.id_of("Comment"))
    sess.create_edge(int(comments[0]), int(comments[1]), "replyOf")
    for vdef in chosen:
        assert sess.check_consistency(vdef.name)


@pytest.mark.parametrize("stale", [False, True], ids=["current", "stale"])
def test_precomputed_build_matches_reference(stale):
    out = {}
    for pkg in (P, R):
        sel = MOD[pkg][0]
        sess = session(pkg, SMALL)
        q = pkg.parse_query(HOT2)
        sub = sel.candidate_subpaths([q])[0]
        c = sel.score_candidate(None, sub, [q], name="CAND",
                                stats=sess.selection_stats())
        assert c.measurement.is_current()
        if stale:   # a write on the candidate's label stales its plan
            persons = np.flatnonzero(np.asarray(
                sess.g.node_mask(sess.schema.node_label_id("Person"))))
            sess.create_edge(int(persons[0]), int(persons[1]), "knows")
            assert not c.measurement.is_current()
        misses = sess.planner.plan_misses
        mv = sess.create_view(c.vdef, precomputed=c.measurement)
        assert sess.check_consistency("CAND")
        # a current measurement is installed as is; a stale one is rebuilt
        assert (sess.planner.plan_misses > misses) == stale
        out[pkg] = (sess.views["CAND"].pair_slot, mv.stats().e_vl,
                    mv.stats().init_db_hit, c.e_vl)
    assert out[P] == out[R]


def rows_bytes(res):
    """A result's rows by value, as int32 bytes: the port's set-semantics
    rows are bool, the reference's int32."""
    return np.asarray(res.reach).astype(np.int32).tobytes()


def online_run(pkg, scenario):
    sizes = dict(n_person=200, n_post=120, n_comment=300, n_tag=30)
    sess = session(pkg, sizes)
    _, online, serve, _ = MOD[pkg]
    if scenario == "user view":
        sess.create_view("CREATE VIEW MINE AS (CONSTRUCT (c)-[r:MINE]->(p) "
                         "MATCH (c:Comment)-[:replyOf*..]->(p:Post))")
    eng = sess.serve(serve.ServeConfig(
        online_selection=online.OnlineSelectionConfig(
            min_observations=8, evaluate_every=8, min_uses=2.0,
            max_views=2), **PIN))
    tickets = []
    for _ in range(12):
        tickets.append(eng.submit(HOT))
        if scenario == "hot":
            tickets.append(eng.submit(HOT2))
    eng.run()
    owned_after_hot = sorted(eng.selector.owned_views())
    if scenario == "hot":                # a fence on a funded view's label
        persons = np.flatnonzero(np.asarray(
            sess.g.node_mask(sess.schema.node_label_id("Person"))))
        eng.submit_writes(pkg.WriteBatch().create_edge(
            int(persons[0]), int(persons[1]), "knows"))
    else:
        for _ in range(5):               # drift: decay rounds of new traffic
            for _ in range(10):
                tickets.append(eng.submit(COLD))
            eng.run()
    for q in (HOT, HOT2):
        tickets.append(eng.submit(q))
    eng.run()
    for name in sess.views:
        assert sess.check_consistency(name), name
    st = eng.selector.stats
    return {
        "owned_after_hot": owned_after_hot,
        "owned": sorted(eng.selector.owned_views()),
        "views": {n: v.pair_slot for n, v in sess.views.items()},
        "counters": (st.reads_observed, st.writes_observed, st.evaluations,
                     st.creates, st.drops, st.reused_builds,
                     eng.stats.auto_creates, eng.stats.auto_drops),
        "actions": list(st.actions),
        "reads": [(t.result.src_ids.tolist(), rows_bytes(t.result),
                   t.result.metrics.db_hits, t.result.metrics.rows, t.via)
                  for t in tickets],
    }


@pytest.mark.parametrize("scenario", ["hot", "drift", "user view"])
def test_online_selector_matches_reference(scenario):
    got, want = online_run(P, scenario), online_run(R, scenario)
    assert got["actions"] == want["actions"]
    assert got["counters"] == want["counters"]
    assert got["owned_after_hot"] == want["owned_after_hot"]
    assert got["owned"] == want["owned"]
    assert got["views"] == want["views"]
    assert got["reads"] == want["reads"]
    creates, drops, reused = got["counters"][3:6]
    assert reused == creates
    if scenario == "hot":
        assert len(got["owned"]) == 2 and drops == 0
    elif scenario == "drift":
        assert got["owned_after_hot"] and not got["owned"] and drops >= 1
    else:   # the user's view already serves the hot shape: no duplicate
        assert "MINE" in got["views"] and not got["owned_after_hot"]


def test_budgets_and_weights_match_reference():
    out = {}
    for pkg in (P, R):
        sel = MOD[pkg][0]
        sess = session(pkg, SMALL)
        stats = sess.selection_stats()
        qs = [pkg.parse_query(HOT), pkg.parse_query(HOT2)]
        free = sel.greedy_select(stats, qs, schema=sess.schema, k=4)
        smallest = min(c.e_vl for c in free)
        tight = sel.greedy_select(stats, qs, schema=sess.schema, k=4,
                                  storage_budget=smallest)
        maint = sel.greedy_select(stats, qs, schema=sess.schema, k=4,
                                  write_fraction=1.0, maintenance_budget=1.0)
        weighted = sel.greedy_select(stats, qs, schema=sess.schema, k=4,
                                     weights=[4.0, 0.0])
        out[pkg] = [cands(c) for c in (free, tight, maint, weighted)]
        assert len(tight) < len(free) and sum(c.e_vl for c in tight) \
            <= smallest
        assert sel.greedy_select(stats, qs, schema=sess.schema, k=0) == []
        knows2 = sel._signature(sel.candidate_subpaths([qs[1]])[0])
        assert knows2 not in {sel._signature(c.vdef.match) for c in weighted}
    assert out[P] == out[R]

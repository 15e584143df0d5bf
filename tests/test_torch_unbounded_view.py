"""SNB's unbounded view ``ROOT_POST`` (``(c:Comment)-[:replyOf*..]->
(p:Post)``) kept by its INF_HOPS templates, and the spans of the closures
that keep it.

On seeded small SNB graphs (the benchmark's ``snb_like`` generator, its
``snb_x2`` views), the port's stored pairs after a write are held to the
plain reference's re-derivation (``mvbench/reference/paths.py``); the
``exec.closure`` spans of both closure loops to the reply chains they
walk; and ``maint.view``'s ``unbounded`` attr to the views' hop ranges."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as P
from repro_torch.core import executor as p_exec
from repro_torch.core import plan as p_plan
from repro_torch.utils import trace
from mvbench import harness
from mvbench.reference.paths import Evaluator, GraphState, is_counting

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "mvbench/configs/snb_x2.json").read_text())
VIEWS = {v["name"]: v for v in CONFIG["views"]}
SIZES = {"n_person": 24, "n_place": 4, "n_post": 12, "n_tag": 6,
         "n_comment": 160, "knows_deg": 2.0}
Q_ROOT_POST = "MATCH (c:Comment)-[:replyOf*..]->(p:Post) RETURN c, p"


def snb(seed: int):
    """A session on the CPU over a seeded small SNB graph with the three
    views, and the reference's state of the same graph (an edge's id is
    its arena slot, as in the benchmark)."""
    gen = harness.plugin("generators", "snb_like", ROOT, ["mvbench"])
    data = gen.generate(harness.seed_rng(seed, "data"), SIZES)
    schema = P.GraphSchema()
    b = P.GraphBuilder(schema)
    for lab in data["node_label"].tolist():
        b.add_node(data["node_labels"][lab])
    for s, d, lab in zip(data["src"].tolist(), data["dst"].tolist(),
                         data["edge_label"].tolist()):
        b.add_edge(s, d, data["edge_labels"][lab])
    sess = P.GraphSession(b.finalize(slack=1.5, device="cpu"), schema,
                          device="cpu")
    for v in CONFIG["views"]:
        sess.create_view(v["cypher"])
    return sess, GraphState.from_data(data)


def parent_of(state: GraphState) -> dict:
    """Each Comment's ``replyOf`` target."""
    h = state.edges_of("replyOf")
    return dict(zip(state.src[h].tolist(), state.dst[h].tolist()))


def depth(state: GraphState, c: int) -> int:
    """The Comments strictly between ``c`` and its Post."""
    up, k = parent_of(state), 0
    post = state.node_label_id("Post")
    while state.node_label[up[c]] != post:
        c, k = up[c], k + 1
    return k


def subtree(state: GraphState, c: int) -> int:
    """The Comments that reply to ``c``, directly or not."""
    up = parent_of(state)
    return sum(1 for x in up if x != c and _above(up, x, c))


def _above(up: dict, x: int, c: int) -> bool:
    while x in up:
        x = up[x]
        if x == c:
            return True
    return False


def assert_views_match(sess, state: GraphState) -> None:
    stored = harness.stored_view_pairs(sess)
    ev = Evaluator(state, "cpu")
    for name, v in VIEWS.items():
        path = v["path"]
        s, d, c = ev.pairs(path, state.alive_nodes(path["start"]))
        if not is_counting(path):
            c = np.ones_like(c)
        want = dict(zip(zip(s.tolist(), d.tolist()), c.tolist()))
        gs, gd, gc = stored[name]
        got = dict(zip(zip(gs.tolist(), gd.tolist()), gc.tolist()))
        assert got == want, name
    assert len(stored["ROOT_POST"][0]) > 0


def traced(fn):
    with trace.span("untraced"):          # found off: ends the last stretch
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, trace.spans()


def write(sess, state: GraphState, ops) -> None:
    """One fence through ``apply_writes`` and the reference's state."""
    b = P.WriteBatch()
    for op in ops:
        if op[0] == "delete_node":
            b.delete_node(op[1])
        else:
            b.delete_edge(op[1])
    sess.apply_writes(b)
    state.apply(ops)


def comment_mid_chain(state: GraphState) -> int:
    """The Comment that replies to a Comment and has the most replies."""
    up = parent_of(state)
    post = state.node_label_id("Post")
    mids = [c for c in up if state.node_label[up[c]] != post]
    return max(mids, key=lambda c: (subtree(state, c), -c))


def case_dv_mid_chain(sess, state, monkeypatch):
    c = comment_mid_chain(state)
    assert subtree(state, c) > 0
    write(sess, state, [("delete_node", c)])
    assert_views_match(sess, state)


def case_dv_post(sess, state, monkeypatch):
    h = state.edges_of("replyOf")
    posts, n = np.unique(state.dst[h][state.node_label[state.dst[h]]
                                      == state.node_label_id("Post")],
                         return_counts=True)
    write(sess, state, [("delete_node", int(posts[np.argmax(n)]))])
    assert_views_match(sess, state)


def case_de_reply_of(sess, state, monkeypatch):
    c = comment_mid_chain(state)
    h = state.edges_of("replyOf")
    (edge,) = h[state.src[h] == c]
    write(sess, state, [("delete_edge", int(edge))])
    assert_views_match(sess, state)


def deepest(state: GraphState) -> int:
    up = parent_of(state)
    return max(up, key=lambda c: (depth(state, c), -c))


def closure_spans(recs):
    return [r for r in recs if r.name == "exec.closure"]


def case_closure_iters_unfused(sess, state, monkeypatch):
    """The maintenance loop (``PathExecutor._expand_rel``) from one
    Comment: a hop a Comment above it, one to its Post, one that finds
    nothing."""
    c = deepest(state)
    assert depth(state, c) >= 2
    ex = P.PathExecutor(engine=sess.engine, cfg=sess._delta_cfg)
    path = sess.views["ROOT_POST"].vdef.match
    ex.run_path(path, counting=False, sources=np.asarray([c], np.int32))
    _, recs = traced(lambda: ex.run_path(
        path, counting=False, sources=np.asarray([c], np.int32)))
    (sp,) = closure_spans(recs)
    assert sp.attrs["iters"] == depth(state, c) + 1


def case_closure_iters_plan(sess, state, monkeypatch):
    """The compiled plan's loop (``plan._expand_range``), reading its flag
    after every hop."""
    monkeypatch.setattr(p_plan, "CLOSURE_SYNC_EVERY", 1)
    c = deepest(state)
    src = np.asarray([c], np.int32)
    sess.query(Q_ROOT_POST, sources=src, use_views=False)
    _, recs = traced(lambda: sess.query(Q_ROOT_POST, sources=src,
                                        use_views=False))
    (sp,) = closure_spans(recs)
    assert sp.attrs["iters"] == depth(state, c) + 1


def flag_owners(monkeypatch):
    """Patch both closure loops' ``host_flag``: each call notes the span
    innermost at the time (None untraced)."""
    owners = []
    real = p_exec.host_flag

    def noting(x):
        owners.append(trace._open[-1].index if trace._open else None)
        return real(x)

    monkeypatch.setattr(p_exec, "host_flag", noting)
    monkeypatch.setattr(p_plan, "host_flag", noting)
    return owners


def case_closure_pulls(sess, state, monkeypatch):
    """A closure's ``pulls`` are the flags it read, in a fence (DV of a
    mid-chain Comment: the templates and the recompute) and in a read."""
    owners = flag_owners(monkeypatch)
    c = comment_mid_chain(state)
    _, recs = traced(lambda: write(sess, state, [("delete_node", c)]))
    spans = closure_spans(recs)
    assert len(spans) >= 2
    for sp in spans:             # a flag before each hop and one after
        assert sp.attrs["pulls"] == owners.count(sp.index) == \
            sp.attrs["iters"] + 1
    owners.clear()
    _, recs = traced(lambda: sess.query(Q_ROOT_POST, use_views=False))
    (sp,) = closure_spans(recs)
    assert sp.attrs["pulls"] == owners.count(sp.index) == len(owners) > 0


def case_unbounded_attr(sess, state, monkeypatch):
    c = comment_mid_chain(state)
    _, recs = traced(lambda: write(sess, state, [("delete_node", c)]))
    views = {r.attrs["view"]: r.attrs["unbounded"] for r in recs
             if r.name == "maint.view"}
    assert views == {"ROOT_POST": 1, "COMMENT_TAG": 0, "KNOWS2": 0}


CASES = {f.__name__[5:]: f for f in (
    case_dv_mid_chain, case_dv_post, case_de_reply_of,
    case_closure_iters_unfused, case_closure_iters_plan, case_closure_pulls,
    case_unbounded_attr)}


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 31 + 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_root_post_on_small_snb(case, seed, monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    sess, state = snb(seed)
    assert_views_match(sess, state)
    CASES[case](sess, state, monkeypatch)

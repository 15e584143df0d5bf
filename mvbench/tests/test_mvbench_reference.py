"""The plain reference against paths counted by hand, and against the port
on small generated graphs."""
import numpy as np
import pytest
import torch

from mvbench.reference.paths import Evaluator, GraphState, is_counting


def step(rel, d="out", lo=1, hi=1, node="A"):
    return {"rel": rel, "dir": d, "min": lo, "max": hi, "node": node}


def rows(state, path, sources):
    ev = Evaluator(state, "cpu")
    out = {}
    for ids, R in ev.rows(path, np.asarray(sources)):
        for i, r in zip(ids, R):
            nz = torch.nonzero(r).flatten().tolist()
            out[int(i)] = {c: int(r[c]) for c in nz}
    return out


@pytest.fixture
def cyc():
    """A0 -> A1 twice (a duplicate edge), A1 -> A2, A2 -> A0 (a cycle),
    and A0 -y-> B3."""
    return GraphState(("A", "B"), np.array([0, 0, 0, 1]), ("x", "y"),
                      np.array([0, 0, 1, 2, 0]), np.array([1, 1, 2, 0, 3]),
                      np.array([0, 0, 0, 0, 1]))


def test_bounded_counts_walks_through_duplicates_and_cycle(cyc):
    path = {"start": "A", "steps": [step("x", lo=1, hi=2)]}
    assert is_counting(path)
    # A0: A1 by two edges; A2 by two walks (one per duplicate)
    # A1: A2, then A0; A2: A0, then A1 by the two duplicates
    assert rows(cyc, path, [0, 1, 2]) == {0: {1: 2, 2: 2}, 1: {2: 1, 0: 1},
                                          2: {0: 1, 1: 2}}


def test_exact_hops_and_interior_label(cyc):
    three = {"start": "A", "steps": [step("x", lo=3, hi=3)]}
    # three hops from A0 come back to A0 by two walks
    assert rows(cyc, three, [0]) == {0: {0: 2}}
    # A2 -x-> A0 -y-> B3 ; the B filter drops A-labelled ends
    two = {"start": "A", "steps": [step("x"), step("y", node="B")]}
    assert rows(cyc, two, [0, 1, 2]) == {0: {}, 1: {}, 2: {3: 1}}


def test_unbounded_is_set_semantics_and_closes_the_cycle(cyc):
    path = {"start": "A", "steps": [step("x", hi=None)]}
    assert not is_counting(path)
    assert rows(cyc, path, [0]) == {0: {0: 1, 1: 1, 2: 1}}
    zero = {"start": "A", "steps": [step("x", lo=2, hi=None)]}
    assert rows(cyc, zero, [1]) == {1: {0: 1, 1: 1, 2: 1}}


def test_incoming_direction_counts_duplicates(cyc):
    path = {"start": "A", "steps": [step("x", d="in")]}
    assert rows(cyc, path, [1, 0]) == {1: {0: 2}, 0: {2: 1}}


def test_writes_replay(cyc):
    path = {"start": "A", "steps": [step("x", lo=1, hi=2)]}
    h = cyc.apply([("create_edge", 1, 2, "x")])[0]
    assert rows(cyc, path, [0]) == {0: {1: 2, 2: 4}}
    cyc.apply([("delete_edge", h), ("delete_edge", 0)])
    assert rows(cyc, path, [0]) == {0: {1: 1, 2: 1}}
    cyc.apply([("delete_node", 2)])
    assert list(cyc.alive_nodes("A")) == [0, 1]
    assert rows(cyc, path, [0, 1]) == {0: {1: 1}, 1: {}}
    cyc.apply([("create_node", 2)])
    assert list(cyc.alive_nodes("A")) == [0, 1, 2]
    assert rows(cyc, path, [0, 1]) == {0: {1: 1}, 1: {}}
    with pytest.raises(ValueError):
        cyc.apply([("create_edge", 0, 2, "x"), ("create_node", 0)])


@pytest.mark.parametrize("config", ["snb_x2", "finbench_x3_dense"])
def test_reference_equals_port_on_every_read_and_view(tiny_root, config):
    """Every read and view of a configuration, over every source of a graph
    cut a hundredfold: the reference's rows == the port's (views off)."""
    import json
    from repro_torch.core import GraphSession
    from repro_torch.core.graph import GraphBuilder
    from repro_torch.core.schema import GraphSchema
    from mvbench.harness import plugin, seed_rng
    cfg = json.loads((tiny_root / f"mvbench/configs/{config}.json")
                     .read_text())
    gen = plugin("generators", cfg["generator"]["name"], tiny_root, [])
    data = gen.generate(seed_rng(3, "data"), cfg["generator"]["sizes"])
    schema = GraphSchema()
    b = GraphBuilder(schema)
    for lab in data["node_label"]:
        b.add_node(data["node_labels"][lab])
    for s, d, lab in zip(data["src"], data["dst"], data["edge_label"]):
        b.add_edge(int(s), int(d), data["edge_labels"][lab])
    sess = GraphSession(b.finalize(device="cpu"), schema, device="cpu")
    state = GraphState.from_data(data)
    ev = Evaluator(state, "cpu")
    n = state.n_nodes
    for r in cfg["reads"] + cfg["views"]:
        cypher = r["cypher"]
        if cypher.startswith("CREATE VIEW"):
            cypher = cypher[cypher.index("MATCH"):].strip()[:-1] + " RETURN 1"
        got = sess.query(cypher, use_views=False)
        want = state.alive_nodes(r["path"]["start"])
        assert np.array_equal(got.src_ids, want), r["name"]
        full = np.concatenate([R.numpy() for _, R in ev.rows(r["path"], want)])
        assert np.array_equal(got.reach[:, :n], full), r["name"]
        assert not got.reach[:, n:].any()

"""The paper's write protocol: targets drawn uniformly over every base edge
and every node, and a cycle's seven fences ending on the graph it started
from."""
import collections

import numpy as np
import pytest

from mvbench.generators import finbench_like
from mvbench.harness import seed_rng
from mvbench.reference.paths import GraphState
from mvbench.writes import WriteTargets

SIZES = {"n_account": 80, "n_person": 30, "n_company": 10, "n_loan": 16,
         "transfer_deg": 5.0}


@pytest.fixture
def state():
    return GraphState.from_data(finbench_like.generate(seed_rng(9, "data"),
                                                       SIZES))


def edges(st):
    h = np.flatnonzero(st.alive[:st.n_edges])
    return collections.Counter(zip(st.src[h].tolist(), st.dst[h].tolist(),
                                   st.lab[h].tolist()))


def test_targets_cover_every_label_and_avoid_the_edge(state):
    targets = WriteTargets(state, seed_rng(2 ** 31 + 1, "writes"))
    node_labels, edge_labels = set(), set()
    for _ in range(400):
        cyc = targets.cycle()
        s, d, lab = state.edge(cyc.e)
        assert cyc.n not in (s, d)
        node_labels.add(int(state.node_label[cyc.n]))
        edge_labels.add(lab)
    assert node_labels == set(range(len(state.node_labels)))
    assert edge_labels == set(state.edge_labels)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_a_cycle_ends_on_the_graph_it_started_from(state, seed):
    targets = WriteTargets(state, seed_rng(seed, "writes"))
    before, nodes = edges(state), state.node_label.copy()
    for _ in range(5):
        cyc = targets.cycle()
        for take in (cyc.ce_write, cyc.de_write, cyc.dv_write):
            take()
        assert state.node_label[cyc.n] < 0
        assert edges(state) != before
        for take in (cyc.ce_recover, cyc.de_recover, cyc.dv_recover_node,
                     cyc.dv_recover_edges):
            take()
        assert edges(state) == before
        assert np.array_equal(state.node_label, nodes)

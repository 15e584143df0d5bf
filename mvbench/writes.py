"""The paper's writes: CE, DE and DV, each with its recover.

Frozen copy of the protocol of ``chip_smoke.py::write_targets`` and
``run_writes`` (at commit a5f2a9c), which draw as the paper's driver does:
one base edge ``e`` uniformly over the alive base edges and one node ``n``
uniformly over the alive nodes per cycle.  CE creates a second edge with
``e``'s endpoints and label and its recover deletes it, DE deletes ``e``
and its recover creates it again, DV deletes ``n`` (and with it every
incident edge) and its recover creates ``n`` again and then its base
edges.  Each step is one fence (one ``WriteBatch``).  Writes name edges by
their id in :class:`~mvbench.reference.paths.GraphState` (creation order);
the harness maps ids to the port's arena slots.  ``n`` is never an
endpoint of ``e``: a loop that applies the three writes before their
recovers would otherwise recreate ``e`` on a deleted node.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from mvbench.reference.paths import GraphState


@dataclass
class Fence:
    """One write batch: ``ops`` are ``("create_edge", s, d, label)``,
    ``("delete_edge", id)``, ``("delete_node", n)``, ``("create_node", n)``.
    ``created`` gets the state ids of the edges it creates, in order."""

    kind: str
    ops: list
    created: List[int] = field(default_factory=list)


class WriteCycle:
    """CE, DE and DV on one drawn edge and node, with their recovers: one
    method a fence.  Each fence's ops are fixed when it is taken, against
    the state as it stands then, and applied to that state at once."""

    def __init__(self, state: GraphState, edge: int, node: int):
        self.state, self.e, self.n = state, edge, node
        self.ce: Optional[Fence] = None
        self.killed: List[int] = []

    def _take(self, kind: str, ops: list) -> Fence:
        f = Fence(kind, ops)
        f.created = self.state.apply(ops)
        return f

    def ce_write(self) -> Fence:
        s, d, lab = self.state.edge(self.e)
        self.ce = self._take("CE", [("create_edge", s, d, lab)])
        return self.ce

    def ce_recover(self) -> Fence:
        return self._take("CE.recover", [("delete_edge", self.ce.created[0])])

    def de_write(self) -> Fence:
        return self._take("DE", [("delete_edge", self.e)])

    def de_recover(self) -> Fence:
        s, d, lab = self.state.edge(self.e)
        return self._take("DE.recover", [("create_edge", s, d, lab)])

    def dv_write(self) -> Fence:
        st = self.state
        e = slice(0, st.n_edges)
        self.killed = [int(h) for h in np.flatnonzero(
            st.alive[e] & ((st.src[e] == self.n) | (st.dst[e] == self.n)))]
        return self._take("DV", [("delete_node", self.n)])

    def dv_recover_node(self) -> Fence:
        return self._take("DV.recover_node", [("create_node", self.n)])

    def dv_recover_edges(self) -> Fence:
        return self._take("DV.recover_edges",
                          [("create_edge", *self.state.edge(h))
                           for h in self.killed])


class WriteTargets:
    """Draws each cycle's edge and node uniformly from ``rng``."""

    def __init__(self, state: GraphState, rng: np.random.Generator):
        self.state, self.rng = state, rng

    def cycle(self) -> WriteCycle:
        st = self.state
        e = int(self.rng.choice(np.flatnonzero(st.alive[:st.n_edges])))
        s, d, _ = st.edge(e)
        ok = st.node_label >= 0
        ok[[s, d]] = False
        return WriteCycle(st, e, int(self.rng.choice(np.flatnonzero(ok))))

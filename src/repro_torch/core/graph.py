"""Tensor property-graph store (the port of ``repro.core.graph``).

A fixed-capacity *arena* of tensors with alive masks:

* node tensors: ``label``, ``key`` (the primary key the paper's templates
  reference as ``$K:$V``), ``alive``, plus one int32 column per named node
  property (``node_props``)
* edge tensors: ``src``, ``dst``, ``label``, ``alive`` (COO), ``weight``,
  plus one int32 column per named edge property (``edge_props``)

Storage is int32 (bool for the alive masks), as in the reference; indices
widen to int64 only where they are index operands.  Property columns are
created lazily; elements that never had a property read 0, and creating
into a recycled slot zeroes every existing column for that slot.

Mutation is functional: every write clones the tensors it changes and
returns a new :class:`PropertyGraph`.  Maintenance evaluates the old, mid
and new graphs of one write batch side by side on engine snapshots that
share cached state, so no function here writes in place to a tensor an
older graph may still hold.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pattern import _cmp
from repro_torch.core.schema import GraphSchema, NO_LABEL
from repro_torch.utils import host, resolve_device, round_up
from repro_torch.utils.device import DeviceLike

DEAD = -1  # label value for dead slots


# ---------------------------------------------------------------------------
# Per-label mutation epochs (host-side version counters)
# ---------------------------------------------------------------------------

class LabelEpochs:
    """Per-edge-label version counters for fine-grained cache invalidation.

    The :class:`PropertyGraph` itself is immutable; a mutation produces a new
    graph.  What persists across versions is the *engine* (executor caches),
    and it needs to know which labels a mutation touched.  Every mutation
    bumps the epoch of each edge label it touched; cache entries record the
    epoch they were built at and are stale iff the label's epoch moved.

    Wildcard (``NO_LABEL``) entries depend only on the **base** edge labels,
    so they key off a separate *base generation* that moves only when a
    mutation touches at least one base label.  ``reset_generation`` moves
    only on full invalidations (node-arena growth, external graph swaps).
    """

    def __init__(self) -> None:
        self._by_label: Dict[int, int] = {}
        self.base_generation: int = 0
        self.reset_generation: int = 0

    def of(self, label_id: int) -> int:
        if label_id == NO_LABEL:
            return self.base_generation
        return self._by_label.get(label_id, 0)

    def bump(self, label_ids: Iterable[int], touches_base: bool = True) -> None:
        if touches_base:
            self.base_generation += 1
        for lid in label_ids:
            if lid == NO_LABEL:
                continue
            self._by_label[lid] = self._by_label.get(lid, 0) + 1

    def bump_all(self) -> None:
        self.base_generation += 1
        self.reset_generation += 1
        for lid in list(self._by_label):
            self._by_label[lid] += 1

    def snapshot(self) -> "LabelEpochs":
        e = LabelEpochs()
        e._by_label = dict(self._by_label)
        e.base_generation = self.base_generation
        e.reset_generation = self.reset_generation
        return e


# ---------------------------------------------------------------------------
# Write batches (the unit of batched maintenance)
# ---------------------------------------------------------------------------

@dataclass
class WriteBatch:
    """A group of base-graph mutations applied (and maintained) together.

    Application order is fixed: **edge deletes, then edge creates, then node
    creates, then node deletes**, then property sets.  Deletes and creates
    telescope around a common mid graph; node deletes are handled last by
    affected-source recompute on the final graph.
    """

    edge_creates: List[Tuple[int, int, str]] = field(default_factory=list)
    edge_deletes: List[int] = field(default_factory=list)
    node_creates: List[Tuple[str, Optional[int]]] = field(default_factory=list)
    node_deletes: List[int] = field(default_factory=list)
    # property updates, applied after all structural steps:
    # (node_id / edge_id, prop name, value)
    node_prop_sets: List[Tuple[int, str, int]] = field(default_factory=list)
    edge_prop_sets: List[Tuple[int, str, int]] = field(default_factory=list)
    # props on elements created by THIS batch: (index into edge_creates /
    # node_creates, prop name, value); resolved to arena ids at apply time
    edge_create_props: List[Tuple[int, str, int]] = field(default_factory=list)
    node_create_props: List[Tuple[int, str, int]] = field(default_factory=list)
    # per-view freshness override for THIS batch: view name -> mode
    refresh_routing: Dict[str, str] = field(default_factory=dict)

    def route_view(self, name: str, mode: str) -> "WriteBatch":
        """Override one view's freshness mode for this batch only."""
        if mode not in ("exact", "deferred", "bounded_stale"):
            raise ValueError(f"unknown freshness mode {mode!r}")
        self.refresh_routing[name] = mode
        return self

    def create_edge(self, src: int, dst: int, label: str,
                    props: Optional[Dict[str, int]] = None) -> "WriteBatch":
        idx = len(self.edge_creates)
        self.edge_creates.append((int(src), int(dst), label))
        for k, v in (props or {}).items():
            self.edge_create_props.append((idx, k, int(v)))
        return self

    def delete_edge(self, edge_id: int) -> "WriteBatch":
        self.edge_deletes.append(int(edge_id))
        return self

    def create_node(self, label: str, key: Optional[int] = None,
                    props: Optional[Dict[str, int]] = None) -> "WriteBatch":
        idx = len(self.node_creates)
        self.node_creates.append((label, key))
        for k, v in (props or {}).items():
            self.node_create_props.append((idx, k, int(v)))
        return self

    def delete_node(self, node_id: int) -> "WriteBatch":
        self.node_deletes.append(int(node_id))
        return self

    def set_node_prop(self, node_id: int, prop: str, value: int) -> "WriteBatch":
        self.node_prop_sets.append((int(node_id), prop, int(value)))
        return self

    def set_edge_prop(self, edge_id: int, prop: str, value: int) -> "WriteBatch":
        self.edge_prop_sets.append((int(edge_id), prop, int(value)))
        return self

    def __len__(self) -> int:
        return (len(self.edge_creates) + len(self.edge_deletes)
                + len(self.node_creates) + len(self.node_deletes)
                + len(self.node_prop_sets) + len(self.edge_prop_sets))


@dataclass(frozen=True)
class PropertyGraph:
    """A property graph as a frozen dataclass of tensors on one device."""

    node_label: torch.Tensor   # int32 [N_cap]
    node_key: torch.Tensor     # int32 [N_cap]
    node_alive: torch.Tensor   # bool  [N_cap]
    edge_src: torch.Tensor     # int32 [E_cap]
    edge_dst: torch.Tensor     # int32 [E_cap]
    edge_label: torch.Tensor   # int32 [E_cap]
    edge_alive: torch.Tensor   # bool  [E_cap]
    edge_weight: torch.Tensor  # int32 [E_cap]; base edges 1, view edges = path count
    node_props: Dict[str, torch.Tensor] = field(default_factory=dict)
    edge_props: Dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.node_label.device

    @property
    def node_cap(self) -> int:
        return self.node_label.shape[0]

    @property
    def edge_cap(self) -> int:
        return self.edge_src.shape[0]

    def to(self, device) -> "PropertyGraph":
        """The same graph with every tensor on ``device``."""
        return PropertyGraph(
            *(getattr(self, f).to(device) for f in (
                "node_label", "node_key", "node_alive", "edge_src",
                "edge_dst", "edge_label", "edge_alive", "edge_weight")),
            node_props={k: v.to(device) for k, v in self.node_props.items()},
            edge_props={k: v.to(device) for k, v in self.edge_props.items()})

    def num_nodes(self) -> int:
        return int(self.node_alive.sum())

    def num_edges(self) -> int:
        return int(self.edge_alive.sum())

    # ------------------------------------------------------------------ masks

    def node_mask(self, label_id: int, key: int | None = None) -> torch.Tensor:
        """bool [N_cap]: alive nodes matching ``label_id`` (wildcard NO_LABEL)."""
        m = self.node_alive
        if label_id != NO_LABEL:
            m = m & (self.node_label == label_id)
        if key is not None:
            m = m & (self.node_key == key)
        return m

    def edge_mask(self, label_id: int) -> torch.Tensor:
        """bool [E_cap] over ``label_id`` edges.  ``NO_LABEL`` here means
        *every* alive edge — view edges included; schema-aware wildcard
        masking (base labels only) lives in ``ExecEngine._edge_mask_for``."""
        m = self.edge_alive
        if label_id != NO_LABEL:
            m = m & (self.edge_label == label_id)
        return m

    # ------------------------------------------------------------ properties

    def node_prop_col(self, prop: str) -> torch.Tensor:
        """int32 [N_cap] column for ``prop`` (all-zeros if never set)."""
        col = self.node_props.get(prop)
        if col is not None:
            return col
        return torch.zeros(self.node_cap, dtype=torch.int32, device=self.device)

    def edge_prop_col(self, prop: str) -> torch.Tensor:
        col = self.edge_props.get(prop)
        if col is not None:
            return col
        return torch.zeros(self.edge_cap, dtype=torch.int32, device=self.device)


def node_pred_mask(g: PropertyGraph, preds) -> torch.Tensor:
    """bool [N_cap]: nodes satisfying every predicate (device-side mask)."""
    m = torch.ones(g.node_cap, dtype=torch.bool, device=g.device)
    for p in preds:
        m = m & _cmp(g.node_prop_col(p.prop), p.op, p.value)
    return m


def edge_pred_mask(g: PropertyGraph, preds) -> torch.Tensor:
    """bool [E_cap]: edges satisfying every predicate (device-side mask)."""
    m = torch.ones(g.edge_cap, dtype=torch.bool, device=g.device)
    for p in preds:
        m = m & _cmp(g.edge_prop_col(p.prop), p.op, p.value)
    return m


def gathered_pred_mask(props: Dict[str, torch.Tensor], preds,
                       ids: np.ndarray) -> np.ndarray:
    """Host bool mask over ``ids``: which elements satisfy every predicate
    (a missing property column reads as 0).  One column pull per predicate."""
    m = np.ones(ids.shape[0], bool)
    for p in preds:
        col = props.get(p.prop)
        vals = (host(col)[ids] if col is not None
                else np.zeros(ids.shape[0], np.int32))
        m &= _cmp(vals, p.op, p.value)
    return m


# ---------------------------------------------------------------------------
# Functional mutation: each write clones what it changes
# ---------------------------------------------------------------------------

def _index(ids, device: torch.device) -> torch.Tensor:
    """Host ids (int, list, numpy) or a tensor -> int64 index tensor."""
    if isinstance(ids, torch.Tensor):
        return ids.to(device=device, dtype=torch.int64).reshape(-1)
    return torch.as_tensor(np.asarray(ids, np.int64).reshape(-1),
                           device=device)


def _values(vals, n: int, device: torch.device) -> torch.Tensor:
    """Scalar or per-element host values -> int32 tensor of length ``n``."""
    if isinstance(vals, torch.Tensor):
        t = vals.to(device=device, dtype=torch.int32).reshape(-1)
    else:
        t = torch.as_tensor(np.asarray(vals, np.int32).reshape(-1),
                            device=device)
    return t.expand(n) if t.numel() == 1 and n != 1 else t


def _set(col: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``col.at[idx].set(vals)`` on a copy."""
    out = col.clone()
    out[idx] = vals
    return out


def _cleared(props: Dict[str, torch.Tensor],
             idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Zero every property column at ``idx`` (slot-recycling hygiene)."""
    return {k: _set(col, idx, 0) for k, col in props.items()}


def delete_node(g: PropertyGraph, node_id) -> PropertyGraph:
    """Delete a node and every incident edge (paper §IV-B 'Delete a node')."""
    return delete_nodes(g, [int(node_id)])


def delete_edge(g: PropertyGraph, edge_id) -> PropertyGraph:
    return delete_edges(g, [int(edge_id)])


def delete_edges(g: PropertyGraph, edge_ids) -> PropertyGraph:
    idx = _index(edge_ids, g.device)
    return replace(g, edge_alive=_set(g.edge_alive, idx, False))


def create_edge(g: PropertyGraph, slot, src, dst, label_id,
                weight=1) -> PropertyGraph:
    """Write an edge into a free slot (host finds the slot; see free_edge_slots)."""
    return create_edges(g, [int(slot)], [int(src)], [int(dst)], label_id,
                        [int(weight)])


def create_edges(g: PropertyGraph, slots, src, dst, label_id,
                 weight) -> PropertyGraph:
    """Vectorized multi-edge write (used by view materialization)."""
    dev = g.device
    idx = _index(slots, dev)
    n = idx.shape[0]
    return replace(
        g,
        edge_src=_set(g.edge_src, idx, _values(src, n, dev)),
        edge_dst=_set(g.edge_dst, idx, _values(dst, n, dev)),
        edge_label=_set(g.edge_label, idx, int(label_id)),
        edge_alive=_set(g.edge_alive, idx, True),
        edge_weight=_set(g.edge_weight, idx, _values(weight, n, dev)),
        edge_props=_cleared(g.edge_props, idx),
    )


def set_node_props(g: PropertyGraph, slots, prop: str, values) -> PropertyGraph:
    """Set ``prop`` on the given node slots (creates the column lazily)."""
    idx = _index(slots, g.device)
    col = _set(g.node_prop_col(prop), idx,
               _values(values, idx.shape[0], g.device))
    return replace(g, node_props={**g.node_props, prop: col})


def set_edge_props(g: PropertyGraph, slots, prop: str, values) -> PropertyGraph:
    """Set ``prop`` on the given edge slots (creates the column lazily)."""
    idx = _index(slots, g.device)
    col = _set(g.edge_prop_col(prop), idx,
               _values(values, idx.shape[0], g.device))
    return replace(g, edge_props={**g.edge_props, prop: col})


def add_edge_weight(g: PropertyGraph, slots, delta) -> PropertyGraph:
    """Adjust view-edge multiplicities; weight<=0 kills the edge."""
    idx = _index(slots, g.device)
    w = g.edge_weight.clone().index_add_(
        0, idx, _values(delta, idx.shape[0], g.device))
    return replace(g, edge_weight=w, edge_alive=g.edge_alive & (w > 0))


def create_node(g: PropertyGraph, slot, label_id, key) -> PropertyGraph:
    return create_nodes(g, [int(slot)], [int(label_id)], [int(key)])


def create_nodes(g: PropertyGraph, slots, label_ids, keys) -> PropertyGraph:
    """Vectorized multi-node write."""
    dev = g.device
    idx = _index(slots, dev)
    n = idx.shape[0]
    return replace(
        g,
        node_label=_set(g.node_label, idx, _values(label_ids, n, dev)),
        node_key=_set(g.node_key, idx, _values(keys, n, dev)),
        node_alive=_set(g.node_alive, idx, True),
        node_props=_cleared(g.node_props, idx),
    )


def delete_nodes(g: PropertyGraph, node_ids) -> PropertyGraph:
    """Delete many nodes and every incident edge in one masked update."""
    idx = _index(node_ids, g.device)
    dead = torch.zeros(g.node_cap, dtype=torch.bool, device=g.device)
    dead[idx] = True
    incident = dead[g.edge_src.long()] | dead[g.edge_dst.long()]
    return replace(g, node_alive=_set(g.node_alive, idx, False),
                   edge_alive=g.edge_alive & ~incident)


def free_edge_slots(g: PropertyGraph, n: int) -> np.ndarray:
    """Host helper: indices of ``n`` free edge slots (raises if arena is full)."""
    free = np.flatnonzero(~host(g.edge_alive))
    if free.shape[0] < n:
        raise RuntimeError(
            f"edge arena full: need {n} slots, have {free.shape[0]} "
            f"(cap={g.edge_cap}); grow the arena")
    return free[:n]


def free_node_slots(g: PropertyGraph, n: int) -> np.ndarray:
    free = np.flatnonzero(~host(g.node_alive))
    if free.shape[0] < n:
        raise RuntimeError(
            f"node arena full: need {n} slots, have {free.shape[0]} "
            f"(cap={g.node_cap}); grow the arena")
    return free[:n]


def _pad(col: torch.Tensor, pad: int, fill) -> torch.Tensor:
    return torch.cat([col, torch.full((pad,), fill, dtype=col.dtype,
                                      device=col.device)])


def grow_node_arena(g: PropertyGraph, new_cap: int) -> PropertyGraph:
    """Node reallocation.  Growing changes ``node_cap`` — the shape of
    frontiers, degree vectors and dense adjacency — so engine caches built at
    the old capacity must be fully invalidated by the caller."""
    new_cap = round_up(max(new_cap, g.node_cap), 128)
    pad = new_cap - g.node_cap
    if pad == 0:
        return g
    return replace(
        g,
        node_label=_pad(g.node_label, pad, DEAD),
        node_key=_pad(g.node_key, pad, DEAD),
        node_alive=_pad(g.node_alive, pad, False),
        node_props={k: _pad(col, pad, 0) for k, col in g.node_props.items()},
    )


def grow_edge_arena(g: PropertyGraph, new_cap: int) -> PropertyGraph:
    """Edge reallocation (the arena analogue of B-tree splits)."""
    new_cap = round_up(max(new_cap, g.edge_cap), 128)
    pad = new_cap - g.edge_cap
    if pad == 0:
        return g
    return replace(
        g,
        edge_src=_pad(g.edge_src, pad, 0),
        edge_dst=_pad(g.edge_dst, pad, 0),
        edge_label=_pad(g.edge_label, pad, DEAD),
        edge_alive=_pad(g.edge_alive, pad, False),
        edge_weight=_pad(g.edge_weight, pad, 1),
        edge_props={k: _pad(col, pad, 0) for k, col in g.edge_props.items()},
    )


# ---------------------------------------------------------------------------
# Host-side builder
# ---------------------------------------------------------------------------

@dataclass
class GraphBuilder:
    """Accumulates nodes/edges host-side (numpy), then finalizes to a device."""

    schema: GraphSchema

    def __post_init__(self):
        self._nlabel: list[int] = []
        self._nkey: list[int] = []
        self._esrc: list[int] = []
        self._edst: list[int] = []
        self._elabel: list[int] = []
        # prop name -> {element index -> value} (sparse host accumulation)
        self._nprops: Dict[str, Dict[int, int]] = {}
        self._eprops: Dict[str, Dict[int, int]] = {}

    def add_node(self, label: str, key: int | None = None,
                 props: Optional[Dict[str, int]] = None) -> int:
        nid = len(self._nlabel)
        self._nlabel.append(self.schema.node_labels.intern(label))
        self._nkey.append(nid if key is None else int(key))
        for k, v in (props or {}).items():
            self._nprops.setdefault(k, {})[nid] = int(v)
        return nid

    def add_edge(self, src: int, dst: int, label: str,
                 props: Optional[Dict[str, int]] = None) -> int:
        eid = len(self._esrc)
        self._esrc.append(int(src))
        self._edst.append(int(dst))
        self._elabel.append(self.schema.edge_labels.intern(label))
        for k, v in (props or {}).items():
            self._eprops.setdefault(k, {})[eid] = int(v)
        return eid

    @property
    def num_nodes(self) -> int:
        return len(self._nlabel)

    @property
    def num_edges(self) -> int:
        return len(self._esrc)

    def finalize(self, node_cap: int | None = None,
                 edge_cap: int | None = None, slack: float = 1.5,
                 device: DeviceLike = None) -> PropertyGraph:
        """Ship the accumulated graph to ``device`` (``None``: the card)."""
        dev = resolve_device(device)
        n = len(self._nlabel)
        e = len(self._esrc)
        node_cap = round_up(node_cap or max(int(n * slack), n + 128), 128)
        edge_cap = round_up(edge_cap or max(int(e * slack), e + 128), 128)
        if node_cap < n or edge_cap < e:
            raise ValueError("capacity smaller than contents")

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(dev)

        def pad_i32(vals, cap, fill):
            a = np.full(cap, fill, np.int32)
            a[: len(vals)] = np.asarray(vals, np.int32)
            return put(a)

        def mask(nlive, cap):
            a = np.zeros(cap, bool)
            a[:nlive] = True
            return put(a)

        def prop_cols(sparse, cap):
            out = {}
            for name, by_idx in sparse.items():
                a = np.zeros(cap, np.int32)
                a[np.fromiter(by_idx.keys(), np.int64, len(by_idx))] = \
                    np.fromiter(by_idx.values(), np.int32, len(by_idx))
                out[name] = put(a)
            return out

        return PropertyGraph(
            node_label=pad_i32(self._nlabel, node_cap, DEAD),
            node_key=pad_i32(self._nkey, node_cap, DEAD),
            node_alive=mask(n, node_cap),
            edge_src=pad_i32(self._esrc, edge_cap, 0),
            edge_dst=pad_i32(self._edst, edge_cap, 0),
            edge_label=pad_i32(self._elabel, edge_cap, DEAD),
            edge_alive=mask(e, edge_cap),
            edge_weight=put(np.ones(edge_cap, np.int32)),
            node_props=prop_cols(self._nprops, node_cap),
            edge_props=prop_cols(self._eprops, edge_cap),
        )


def find_node(g: PropertyGraph, label_id: int, key: int) -> int:
    """Host helper: node id with (label, key) — the paper's ``$L{$K:$V}`` lookup."""
    idx = np.flatnonzero(host(g.node_mask(label_id, key)))
    if idx.shape[0] == 0:
        raise KeyError(f"no node with label={label_id} key={key}")
    return int(idx[0])


def edges_of(g: PropertyGraph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host view of alive edges: (eids, src, dst)."""
    alive = np.flatnonzero(host(g.edge_alive))
    return alive, host(g.edge_src)[alive], host(g.edge_dst)[alive]

"""Label registry for property graphs.

The paper's model (Definition 1) labels every node and edge with exactly one
label.  We intern label strings to dense int ids so that all on-device
filtering is integer comparison.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

NO_LABEL = -1     # wildcard: matches any label
NEVER_LABEL = -2  # unknown label: matches nothing (no instances exist yet)


@dataclass
class LabelRegistry:
    """Bidirectional mapping between label strings and dense int ids."""

    _to_id: Dict[str, int] = field(default_factory=dict)
    _to_name: List[str] = field(default_factory=list)

    def intern(self, name: str) -> int:
        if name in self._to_id:
            return self._to_id[name]
        idx = len(self._to_name)
        self._to_id[name] = idx
        self._to_name.append(name)
        return idx

    def id_of(self, name: str) -> int:
        if name not in self._to_id:
            raise KeyError(f"unknown label {name!r}; known: {self._to_name}")
        return self._to_id[name]

    def maybe_id(self, name: str | None) -> int:
        """Like :meth:`id_of` but maps ``None`` to the wildcard ``NO_LABEL``
        and labels with no instances yet to ``NEVER_LABEL`` (matches nothing,
        like a GDBMS query over a label that has no index entries)."""
        if name is None:
            return NO_LABEL
        if name not in self._to_id:
            return NEVER_LABEL
        return self._to_id[name]

    def name_of(self, idx: int) -> str:
        return self._to_name[idx]

    def __contains__(self, name: str) -> bool:
        return name in self._to_id

    def __len__(self) -> int:
        return len(self._to_name)


@dataclass
class GraphSchema:
    """Schema of a property graph: separate registries for node and edge labels.

    Edge labels are partitioned into **base** and **view** labels.  The paper
    materializes view results as real edges (labeled with the view name) in
    the same graph, so without the partition a wildcard relationship
    ``-[r]->`` would silently match view edges too — phantom rows that change
    wildcard query results whenever a view is created.  ``register_view_label``
    marks a label as view-owned; wildcard compilation (executor), maintenance
    triggering, and consistency checks all consult the partition so that
    ``NO_LABEL`` means "any *base* label".  A label stays a view label for the
    schema's lifetime (dropping a view deletes its edges, but the label id
    remains reserved for it).
    """

    node_labels: LabelRegistry = field(default_factory=LabelRegistry)
    edge_labels: LabelRegistry = field(default_factory=LabelRegistry)
    view_edge_ids: Set[int] = field(default_factory=set)

    def node_label_id(self, name: str | None) -> int:
        return self.node_labels.maybe_id(name)

    def edge_label_id(self, name: str | None) -> int:
        return self.edge_labels.maybe_id(name)

    # -- base/view edge-label partition ----------------------------------

    def register_view_label(self, name: str) -> int:
        """Intern ``name`` as an edge label owned by a materialized view."""
        lid = self.edge_labels.intern(name)
        self.view_edge_ids.add(lid)
        return lid

    def is_view_edge_label(self, name: Optional[str]) -> bool:
        return (name is not None and name in self.edge_labels
                and self.edge_labels.id_of(name) in self.view_edge_ids)

    def is_view_edge_label_id(self, label_id: int) -> bool:
        return label_id in self.view_edge_ids

    def base_edge_label_ids(self) -> Tuple[int, ...]:
        """Ids of every interned edge label that is not view-owned — the set a
        wildcard relationship expands over."""
        return tuple(i for i in range(len(self.edge_labels))
                     if i not in self.view_edge_ids)

"""Assigned input-shape sets, one per architecture family (the 40 cells)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class LMShape:
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


LM_SHAPES: Dict[str, LMShape] = {
    "train_4k":    LMShape("train",   4_096,   256),
    "prefill_32k": LMShape("prefill", 32_768,  32),
    "decode_32k":  LMShape("decode",  32_768,  128),
    # long-context decode: one new token against a 524,288-token KV cache.
    # Decode cost is linear in seq_len even for full attention; lowered with
    # the sequence-sharded split-KV cache (see DESIGN.md §4).
    "long_500k":   LMShape("decode",  524_288, 1),
}


@dataclass(frozen=True)
class GNNShape:
    kind: str            # "full" | "sampled" | "batched"
    n_nodes: int
    n_edges: int
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    batch_graphs: int = 1


GNN_SHAPES: Dict[str, GNNShape] = {
    "full_graph_sm": GNNShape("full", 2_708, 10_556, d_feat=1_433),
    "minibatch_lg":  GNNShape("sampled", 232_965, 114_615_892,
                              batch_nodes=1_024, fanout=(15, 10)),
    "ogb_products":  GNNShape("full", 2_449_029, 61_859_140, d_feat=100),
    "molecule":      GNNShape("batched", 30, 64, batch_graphs=128),
}


@dataclass(frozen=True)
class RecsysShape:
    kind: str            # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES: Dict[str, RecsysShape] = {
    "train_batch":    RecsysShape("train", 65_536),
    "serve_p99":      RecsysShape("serve", 512, n_candidates=100),
    "serve_bulk":     RecsysShape("serve", 262_144, n_candidates=100),
    "retrieval_cand": RecsysShape("retrieval", 1, n_candidates=1_000_000),
}


def shapes_for(family: str) -> Dict[str, object]:
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
            "recsys": RECSYS_SHAPES}[family]

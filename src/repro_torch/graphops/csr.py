"""COO -> CSR / ELL conversions and COO compaction (host-side, numpy).

The executor's per-label indexes take compact COO slices; the neighbor
sampler and the view-fed training subgraph consume CSR.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def build_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort edges by src; return (indptr [N+1], dst_sorted [E], perm [E])."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    perm = np.argsort(src, kind="stable")
    src_s = src[perm]
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.add.at(indptr, src_s + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, dst[perm], perm


def compact_coo(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
                keep: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Select the kept COO edges and sort them by src (CSR edge order).

    Used by the executor's per-label / all-base-edges indexes: the arena is a
    free-list, so alive edges of many labels interleave; the sort groups each
    source's out-edges contiguously, which keeps the gather/scatter hop's
    memory access pattern CSR-like without materializing ``indptr``.

    Returns ``(src, dst, weight, eids)`` — ``eids`` are the original edge
    indices in slice order, the alignment predicate masks need to gather
    property columns against the compact slice.
    """
    idx = np.flatnonzero(np.asarray(keep))
    src_k = np.asarray(src)[idx]
    perm = np.argsort(src_k, kind="stable")
    return (src_k[perm], np.asarray(dst)[idx][perm],
            np.asarray(weight)[idx][perm], idx[perm].astype(np.int32))


def ell_from_coo(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                 max_deg: int | None = None, pad: int = -1
                 ) -> Tuple[np.ndarray, int]:
    """Pad per-src neighbor lists to uniform width (ELLPACK).

    Returns (neighbors [N, max_deg] with ``pad`` fill, max_deg).
    """
    indptr, dst_s, _ = build_csr(src, dst, num_nodes)
    deg = np.diff(indptr)
    md = int(deg.max()) if max_deg is None and deg.size else (max_deg or 0)
    out = np.full((num_nodes, md), pad, np.int32)
    for v in range(num_nodes):
        lo, hi = indptr[v], indptr[v + 1]
        k = min(hi - lo, md)
        out[v, :k] = dst_s[lo:lo + k]
    return out, md

"""COO compaction (host-side, numpy) for the executor's per-label indexes."""
from __future__ import annotations

from typing import Tuple

import numpy as np


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

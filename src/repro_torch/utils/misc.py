"""Small shared helpers."""
from __future__ import annotations

import numpy as np

#: Sentinel for an unbounded variable-length edge upper hop count (``*n..``).
INF_HOPS = -1


def round_up(x: int, multiple: int) -> int:
    """Round ``x`` up to the next multiple of ``multiple``."""
    if multiple <= 0:
        return x
    return ((x + multiple - 1) // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def pad_to(arr: np.ndarray, length: int, fill) -> np.ndarray:
    """Pad 1-D ``arr`` with ``fill`` up to ``length`` (no-op if already there)."""
    arr = np.asarray(arr)
    if arr.shape[0] > length:
        raise ValueError(f"array of length {arr.shape[0]} exceeds pad target {length}")
    if arr.shape[0] == length:
        return arr
    pad = np.full((length - arr.shape[0],) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)

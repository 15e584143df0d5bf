"""What one count hop needs, whatever implements it, and the card's peaks.

Replaces ``chip_smoke.py::spmm_bound_ms`` (at commit a5f2a9c), which
counted the dense ``[K, N]`` operand that today's route reads: that is the
cost of one implementation, not the least the hop needs, and a sparse or
narrower route would read above 100% against it.  A ``[S, K] x [K, N]``
hop over a label with ``nnz`` live edges needs ``2 S nnz`` operations, the
frontier read once and the output written once at the width the semantics
need (1 B a entry under set semantics, 4 B under counting), and each edge
read once (8 B: two int32 endpoints).
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def hop_ops(S: int, nnz: int) -> float:
    return 2.0 * S * nnz


def hop_bytes(S: int, K: int, N: int, nnz: int, counting: bool) -> float:
    w = 4 if counting else 1
    return float(w * (S * K + S * N) + 8 * nnz)


def hop_least_s(S: int, K: int, N: int, nnz: int, counting: bool) -> float:
    """The least time of the hop on the card: the larger of its operations
    over the int8 tensor-core peak and its bytes over the memory rate."""
    return max(hop_ops(S, nnz) / PEAK_INT8_OPS,
               hop_bytes(S, K, N, nnz, counting) / PEAK_BYTES)

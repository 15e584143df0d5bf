"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its kernel computes with ordinary tensor
operations.  The CPU path and the tests use them; on the card they are the
kernels' oracles and nothing on the main path calls them.
"""
from __future__ import annotations

from typing import Optional

import torch


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 product with TF32 explicitly off: integer-valued operands give
    exact integer sums below 2^24, which TF32's 10-bit mantissa would not."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a.to(torch.float32) @ b.to(torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def block_spmm_ref(F: torch.Tensor, A: torch.Tensor,
                   col_mask: Optional[torch.Tensor] = None,
                   semiring: str = "count") -> torch.Tensor:
    """Frontier-hop semantics of the ``block_spmm`` kernel, in fp32.

    counting: ``out = (F @ A) * mask``;  boolean: ``out = min(F @ A, 1) * mask``.
    Walk counts are exact up to 2^24.
    """
    out = matmul_f32(F, A)
    if semiring == "bool":
        out = torch.clamp_max(out, 1.0)
    if col_mask is not None:
        out = out * col_mask.to(torch.float32)[None, :]
    return out

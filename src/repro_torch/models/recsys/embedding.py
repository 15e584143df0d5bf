"""Embedding table + EmbeddingBag from a gather and a masked mean, the
port of ``repro.models.recsys.embedding``.

Ids must lie in ``[0, vocab)``: the reference's ``jnp.take`` fills an
out-of-range id's row with NaN, while a PyTorch gather raises on the CPU
and faults on the card.  The reference never passes such ids; the port
checks them on the CPU (where the check costs no device sync) and trusts
the caller on the card.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import Params, gather_rows, randn
from repro_torch.utils.device import DeviceLike


def embedding_table_init(gen: torch.Generator, vocab: int, dim: int,
                         dtype: torch.dtype = torch.float32,
                         device: DeviceLike = None) -> Params:
    return {"table": randn(gen, (vocab, dim), dtype, device) * 0.05}


def embedding_lookup(p: Params, ids: torch.Tensor) -> torch.Tensor:
    table = p["table"]
    if ids.device.type == "cpu" and ids.numel():
        lo, hi = int(ids.min()), int(ids.max())
        if lo < 0 or hi >= table.shape[0]:
            raise IndexError(f"ids in [{lo}, {hi}] outside the table's "
                             f"[0, {table.shape[0]})")
    return gather_rows(table, ids)


def embedding_bag(p: Params, ids: torch.Tensor, mask: torch.Tensor,
                  combiner: str = "mean") -> torch.Tensor:
    """ids: [B, L] int; mask: [B, L] bool -> [B, D]."""
    emb = embedding_lookup(p, ids)                      # [B, L, D]
    m = mask.to(emb.dtype)[..., None]
    s = torch.sum(emb * m, dim=1)
    if combiner == "sum":
        return s
    cnt = torch.clamp(torch.sum(m, dim=1), min=1.0)
    return s / cnt

"""Segment-reduction primitives over edge indices (``index_add_`` and
``scatter_reduce``), the port of ``repro.graphops.segment``: mean, std and
softmax within segments, and the coalescing of duplicate pairs."""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def segment_extremum(data: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int, reduce: str) -> torch.Tensor:
    """``reduce`` is "amax" or "amin"; an empty segment gives -inf (max) or
    +inf (min), the identity ``jax.ops.segment_max`` / ``segment_min``
    give it."""
    fill = float("-inf") if reduce == "amax" else float("inf")
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), fill)
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(data), data, reduce,
                              include_self=False)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, eps: float = 1e-9) -> torch.Tensor:
    s = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones(data.shape[:1]), segment_ids,
                      num_segments)
    cnt = torch.clamp_min(cnt, eps)
    return s / cnt[..., None] if data.dim() > 1 else s / cnt


def segment_std(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, eps: float = 1e-5) -> torch.Tensor:
    mean = segment_mean(data, segment_ids, num_segments)
    mean_sq = segment_mean(data * data, segment_ids, num_segments)
    var = torch.clamp_min(mean_sq - mean * mean, 0.0)
    return torch.sqrt(var + eps)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically-stable softmax within segments (GAT-style edge softmax)."""
    ids = segment_ids.long()
    seg_max = segment_extremum(logits, ids, num_segments, "amax")
    ez = torch.exp(logits - seg_max[ids])
    seg_sum = segment_sum(ez, ids, num_segments)
    return ez / torch.clamp_min(seg_sum[ids], 1e-16)


def coalesce_pairs(src: torch.Tensor, dst: torch.Tensor,
                   counts: torch.Tensor, num_nodes: int):
    """Merge duplicate (src, dst) pairs by summing counts.

    Returns (keys, counts, num_unique): the sorted unique keys ``src *
    num_nodes + dst`` in the first ``num_unique`` slots of an ``[n]`` int64
    tensor (zeros after), their summed counts (zeros after), and
    ``num_unique`` as a device scalar (no host read)."""
    key = src.to(torch.int64) * num_nodes + dst.to(torch.int64)
    order = torch.argsort(key, stable=True)
    key_s, cnt_s = key[order], counts[order]
    n = key_s.shape[0]
    new_seg = torch.ones(n, dtype=torch.bool, device=key.device)
    new_seg[1:] = key_s[1:] != key_s[:-1]
    seg_id = torch.cumsum(new_seg.to(torch.int32), 0) - 1
    agg = segment_sum(cnt_s, seg_id, n)
    first = torch.zeros(n, dtype=key_s.dtype, device=key.device)
    first[seg_id.long()] = key_s
    num_unique = seg_id[-1] + 1 if n > 0 else torch.zeros(
        (), dtype=torch.int32, device=key.device)
    return first, agg, num_unique

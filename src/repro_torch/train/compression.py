"""Gradient compression for data-parallel reduction (int8 + error
feedback): the port of ``repro.train.compression``.

The reference runs inside ``shard_map`` and reduces over a mesh axis with
``pmax`` and ``psum``.  Here the shards are a list of per-shard tensors
driven by one process (as ``graphops.distributed`` stands in for
``shard_map``): the scale is shared, the max over shards of each shard's
absmax over 127, and the int8 codes are summed in int32.  The residual of
each shard's quantization is kept as its error feedback and re-injected at
the next step (EF-SGD).
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten

Params = Any


def quantize_int8(xs: Sequence[torch.Tensor]
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Each shard's int8 codes under one scale shared across the shards."""
    amax = torch.stack([torch.max(torch.abs(x)) for x in xs]).max()
    scale = torch.clamp(amax / 127.0, min=1e-12)
    qs = [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
          for x in xs]
    return qs, scale


def compressed_psum(xs: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """int8-compressed mean over shards: (the mean every shard receives,
    each shard's residual)."""
    qs, scale = quantize_int8(xs)
    residuals = [x - q.to(torch.float32) * scale for x, q in zip(xs, qs)]
    tot = qs[0].to(torch.int32)
    for q in qs[1:]:
        tot = tot + q.to(torch.int32)
    return tot.to(torch.float32) * scale / float(len(xs)), residuals


def compressed_grad_reduce(grads: Sequence[Params], ef: Sequence[Params]
                           ) -> Tuple[Params, List[Params]]:
    """Tree-wise compressed mean over shards with error feedback.

    grads, ef: one gradient tree and one error-feedback tree per shard (the
    same structure).  Returns (the reduced gradient tree, each shard's new
    error feedback)."""
    flat_g = [tree_leaves(g) for g in grads]
    flat_e = [tree_leaves(e) for e in ef]
    reduced, resid = [], [[] for _ in grads]
    for i in range(len(flat_g[0])):
        xs = [g[i].to(torch.float32) + e[i] for g, e in zip(flat_g, flat_e)]
        red, res = compressed_psum(xs)
        reduced.append(red)
        for shard, r in zip(resid, res):
            shard.append(r)
    return (tree_unflatten(grads[0], reduced),
            [tree_unflatten(grads[0], r) for r in resid])


def init_error_feedback(params: Params, n_shards: int = 1) -> Params:
    """fp32 zeros shaped like ``params``; with ``n_shards`` > 1, each leaf
    gets a leading shard axis (``ef[..][i]`` is shard i's)."""
    lead = () if n_shards == 1 else (n_shards,)
    return tree_map(lambda p: torch.zeros((*lead, *p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)

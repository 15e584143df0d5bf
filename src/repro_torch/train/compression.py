"""Gradient compression for data-parallel reduction (int8 + error
feedback): the port of ``repro.train.compression``.

The scale is shared, the max over shards of each shard's absmax over
127, and the int8 codes are summed in int32, then divided by the number
of shards.  The residual of each shard's quantization is kept as its error
feedback and re-injected at the next step (EF-SGD).

Two forms compute the same numbers: the ``*_axis`` functions are the
reference's, one rank's tensor reduced over a mesh axis (``pmax`` of the
absmax, an int32 ``all_reduce`` of the codes); the others take a list of
per-shard tensors driven by one process.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import Mesh
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


def quantize_int8_axis(x: torch.Tensor, axis_name: str, mesh: Mesh
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's int8 codes under a scale shared across the mesh axis."""
    amax = C.pmax(torch.max(torch.abs(x)), axis_name, mesh)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_axis(x: torch.Tensor, axis_name: str, mesh: Mesh
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-compressed mean over the mesh axis: (the mean, this rank's
    residual)."""
    q, scale = quantize_int8_axis(x, axis_name, mesh)
    residual = x - q.to(torch.float32) * scale
    tot = C.psum(q.to(torch.int32), axis_name, mesh)
    return (tot.to(torch.float32) * scale / float(mesh.shape[axis_name]),
            residual)


def compressed_grad_reduce_axis(grads: Params, ef: Params, axis_name: str,
                                mesh: Mesh) -> Tuple[Params, Params]:
    """Tree-wise compressed mean over the mesh axis with error feedback:
    (the reduced gradient tree, this rank's new error feedback)."""
    outs = [compressed_psum_axis(g.to(torch.float32) + e, axis_name, mesh)
            for g, e in zip(tree_leaves(grads), tree_leaves(ef))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def init_error_feedback(params: Params, n_shards: int = 1) -> Params:
    """fp32 zeros shaped like ``params``; with ``n_shards`` > 1, each leaf
    gets a leading shard axis (``ef[..][i]`` is shard i's)."""
    lead = () if n_shards == 1 else (n_shards,)
    return tree_map(lambda p: torch.zeros((*lead, *p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)

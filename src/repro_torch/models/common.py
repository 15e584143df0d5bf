"""Shared functional layers over parameter dictionaries: linear, norms,
RoPE, embeddings, MLP.

The reference's layout is kept, so converting weights is a copy: a dense
layer is ``{"w": [d_in, d_out]}`` plus an optional ``"b": [d_out]``, and
``dense`` computes ``x @ w + b``.  Initialisers draw from an explicit
``torch.Generator`` on the generator's own device (a CPU generator gives
the same weights on every device; a CUDA generator draws full-width
weights where they will live) and put the result on ``device``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.utils import resolve_device
from repro_torch.utils.device import DeviceLike

Params = Dict[str, Any]


def randn(gen: Optional[torch.Generator], shape, dtype: torch.dtype,
          device: DeviceLike = None) -> torch.Tensor:
    """Standard normal draws in ``dtype`` on ``gen``'s device, put on
    ``device``; on the ``meta`` device, a meta tensor of the shape (no
    draw, and ``gen`` may be None): the shapes of a parameter tree."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=dev)
    x = torch.randn(tuple(shape), generator=gen, dtype=dtype,
                    device=gen.device)
    return x.to(dev)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: Optional[float] = None, bias: bool = False,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None, lead: Sequence[int] = ()
               ) -> Params:
    """A dense layer; ``lead`` stacks independent layers along leading axes
    (``[*lead, d_in, d_out]``), as the reference's ``vmap`` of an
    initialiser does."""
    dev = resolve_device(device)
    scale = scale if scale is not None else (1.0 / (d_in ** 0.5))
    p = {"w": randn(gen, (*lead, d_in, d_out), dtype, dev).mul_(scale)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=dev)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, lead: Sequence[int] = ()
                 ) -> Params:
    return {"g": torch.ones((*lead, d), dtype=dtype,
                            device=resolve_device(device))}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalizes in fp32 and casts back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["g"].to(torch.float32)).to(x.dtype)


def layernorm_init(d: int, dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    return {"g": torch.ones((d,), dtype=dtype, device=dev),
            "b": torch.zeros((d,), dtype=dtype, device=dev)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(x.dtype)


def mlp_init(gen: torch.Generator, dims: Sequence[int], *, bias: bool = True,
             dtype: torch.dtype = torch.float32,
             device: DeviceLike = None) -> Params:
    return {f"l{i}": dense_init(gen, dims[i], dims[i + 1], bias=bias,
                                dtype=dtype, device=device)
            for i in range(len(dims) - 1)}


def mlp(p: Params, x: torch.Tensor, act=F.silu) -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = dense(p[f"l{i}"], x)
        if i < n - 1:
            x = act(x)
    return x


# ---------------------------------------------------------------------- RoPE

def rope_frequencies(head_dim: int, max_pos: int, theta: float = 10000.0,
                     device: DeviceLike = None):
    """(cos, sin), each fp32 ``[max_pos, head_dim // 2]``."""
    dev = resolve_device(device)
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=dev) / half
    freqs = 1.0 / (theta ** exps)
    t = torch.arange(max_pos, dtype=torch.float32, device=dev)
    ang = torch.outer(t, freqs)                     # [max_pos, half]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: [..., S, D]; positions: broadcastable to [..., S] integers.
    Split halves (not interleaved); computed in fp32, cast to ``x``'s
    dtype."""
    positions = positions.long()
    c = cos[positions]                              # [..., S, D/2]
    s = sin[positions]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> Params:
    return {"table": randn(gen, (vocab, d), dtype, device).mul_(0.02)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids.long()]


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0 (``[*idx.shape, *x.shape[1:]]``) by
    ``index_select``, whose backward is an ``index_add_``: the backward of
    advanced indexing sorts the indices and sums each run of a repeated
    index serially, which padding (every padded edge or triplet points at
    row 0) makes slow on the card."""
    out = torch.index_select(x, 0, idx.reshape(-1).long())
    return out.reshape(*idx.shape, *x.shape[1:])


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list/tuple of parameters."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a nested dict/list/tuple (a
    NamedTuple keeps its type)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tree_zip_map(fn, tree, *others):
    """``fn(leaf, *subtrees)`` for every tensor of ``tree``, with the
    subtrees of ``others`` at the same place; ``others`` may hold more
    structure below a leaf of ``tree`` (8-bit moments hold ``{"q", "s"}``
    there).  Returns a tree shaped like ``tree`` of ``fn``'s results."""
    if isinstance(tree, dict):
        return {k: tree_zip_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_zip_map(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    return fn(tree, *others) if isinstance(tree, torch.Tensor) else tree


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` whose tensors are ``leaves``, in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def count_params(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))

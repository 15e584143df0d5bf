"""Collectives over the named axes of a rank mesh: the ``jax.lax``
collectives that the reference's ``shard_map`` bodies call, and its
``axis_size`` shim.

Each function takes this rank's tensor and the :class:`~launch.mesh.Mesh`;
an ``axes`` argument is one axis name or a tuple of them (a tuple reduces
or gathers over the axes one after another, gathering row-major as JAX's
tiled gather over a tuple does).  Layouts are JAX's tiled ones:
``all_gather`` concatenates the peers' blocks along ``axis`` in peer order;
``all_to_all`` cuts ``split_axis`` into one chunk a peer, sends chunk ``j``
to peer ``j`` and concatenates what it receives along ``concat_axis`` in
peer order.

The differentiable ones carry the reference's transposes: the backward of
``all_gather`` is a reduce-scatter (an all-to-all of the gradient's chunks,
summed), of ``all_to_all`` the reverse all-to-all, of ``psum`` a ``psum``.
``pmax`` takes no gradient.

Data movement goes as raw bytes (an ``int8`` view): every dtype moves,
exactly, whatever dtypes the backend takes (gloo refuses int16, for one).  Under ``gloo`` a tensor
off the CPU is copied to host memory for the collective and its result
copied back to the tensor's device (gloo's CUDA support differs op by op
between builds; one explicit path serves them all).  Every call counts its
calls, the bytes handed to it and its output's bytes in ``mesh.counts``;
copies through host memory count under ``"staged"``.  On a meta mesh
(``launch.mesh.make_meta_mesh``) every collective takes ``meta`` tensors
(anything else raises), exchanges nothing and returns a ``meta`` tensor of
its output's shape, counted as a real mesh counts it.

``psum_scatter`` is the tiled reduce-scatter (sum over the peers, each
keeping its block along ``axis``), with an all-gather as its transpose.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import Mesh

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_index(axis: str, mesh: Mesh) -> int:
    """This rank's index along ``axis``."""
    return mesh.coords()[axis]


def axis_size(axis: str, mesh: Mesh) -> int:
    return mesh.shape[axis]


def _check_meta(x: torch.Tensor, mesh: Mesh) -> bool:
    """True on a meta mesh (and ``x`` is then a meta tensor)."""
    if not mesh.is_meta:
        return False
    if x.device.type != "meta":
        raise TypeError(f"a meta mesh's collectives take meta tensors, got "
                        f"one on {x.device}")
    return True


def _to_host(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.backend == "gloo" and x.device.type != "cpu":
        mesh.count("staged", x.nbytes)
        return x.cpu()
    return x


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.int8)


def _gather_list(x: torch.Tensor, axis: str, mesh: Mesh
                 ) -> List[torch.Tensor]:
    """Every peer's ``x`` along ``axis``, in peer order."""
    import torch.distributed as dist
    n = mesh.shape[axis]
    mesh.count("all_gather", x.nbytes, n * x.nbytes, axis)
    if _check_meta(x, mesh) or n == 1:
        return [x] * n
    raw = _to_host(_bytes(x), mesh)
    outs = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(outs, raw, group=mesh.groups[axis])
    return [o.to(x.device).view(x.dtype).reshape(x.shape) for o in outs]


def _exchange(chunks: List[torch.Tensor], axis: str, mesh: Mesh, name: str,
              out_bytes: int) -> List[torch.Tensor]:
    """All-to-all: ``chunks[j]`` goes to peer ``j``; returns what each
    peer sent here, in peer order.  The chunks share a shape."""
    import torch.distributed as dist
    stacked = torch.stack(chunks)
    mesh.count(name, stacked.nbytes, out_bytes, axis)
    n = mesh.shape[axis]
    if _check_meta(stacked, mesh):
        return list(stacked.unbind(0))
    if n == 1:
        return [stacked[0]]
    raw = _to_host(_bytes(stacked), mesh)
    out = torch.empty_like(raw)
    dist.all_to_all_single(out, raw, group=mesh.groups[axis])
    got = out.to(stacked.device).view(stacked.dtype).reshape(stacked.shape)
    return list(got.unbind(0))


def _reduce(x: torch.Tensor, axis: str, mesh: Mesh, op: str, name: str
            ) -> torch.Tensor:
    import torch.distributed as dist
    mesh.count(name, x.nbytes, x.nbytes, axis)
    if _check_meta(x, mesh) or mesh.shape[axis] == 1:
        return x.clone()
    buf = _to_host(x.contiguous(), mesh)
    if buf.device == x.device:          # not staged: reduce into a copy
        buf = buf.clone()
    dist.all_reduce(buf, op=getattr(dist.ReduceOp, op),
                    group=mesh.groups[axis])
    return buf.to(x.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.axis, ctx.mesh, ctx.dim = axis, mesh, dim
        return torch.cat(_gather_list(x, axis, mesh), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axis, ctx.mesh, ctx.dim), None, None, None


def _reduce_scatter(x: torch.Tensor, axis: str, mesh: Mesh, dim: int
                    ) -> torch.Tensor:
    """Sum over the peers along ``axis``, keeping this peer's block of dim
    ``dim`` (an all-to-all of the chunks, summed; bf16 and fp16 summed in
    fp32)."""
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter over {axis!r} ({n} peers) cannot "
                         f"split dim {dim} of {tuple(x.shape)}")
    parts = _exchange(list(x.contiguous().chunk(n, dim)), axis, mesh,
                      "reduce_scatter", x.nbytes // n)
    if x.dtype in (torch.float16, torch.bfloat16):
        return sum(p.to(torch.float32) for p in parts).to(x.dtype)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.axis, ctx.mesh, ctx.dim = axis, mesh, dim
        return _reduce_scatter(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return (torch.cat(_gather_list(g.contiguous(), ctx.axis, ctx.mesh),
                          dim=ctx.dim), None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, split_axis, concat_axis):
        ctx.args = (axis, mesh, split_axis, concat_axis)
        return _all_to_all(x, axis, mesh, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis, mesh, split_axis, concat_axis = ctx.args
        return (_all_to_all(g, axis, mesh, concat_axis, split_axis),
                None, None, None, None)


def _all_to_all(x, axis, mesh, split_axis, concat_axis):
    n = mesh.shape[axis]
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all over {axis!r} ({n} peers) cannot split "
                         f"dim {split_axis} of {tuple(x.shape)}")
    parts = _exchange([c.contiguous() for c in x.chunk(n, split_axis)],
                      axis, mesh, "all_to_all", x.nbytes)
    return torch.cat(parts, dim=concat_axis)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return _reduce(x, axis, mesh, "SUM", "psum")

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.axis, ctx.mesh, "SUM", "psum"), None, None


def all_gather(x: torch.Tensor, axes: Axes, mesh: Mesh, axis: int = 0
               ) -> torch.Tensor:
    """Tiled all-gather along dim ``axis`` (differentiable)."""
    for a in reversed(_axes(axes)):
        x = _AllGather.apply(x, a, mesh, axis)
    return x


def psum_scatter(x: torch.Tensor, axes: Axes, mesh: Mesh, axis: int = 0
                 ) -> torch.Tensor:
    """Tiled reduce-scatter along dim ``axis`` over ``axes`` (the inverse
    layout of :func:`all_gather` over the same axes; differentiable, the
    backward an all-gather)."""
    for a in _axes(axes):
        x = _ReduceScatter.apply(x, a, mesh, axis)
    return x


def all_to_all(x: torch.Tensor, axis_name: str, mesh: Mesh,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all over one axis (differentiable)."""
    return _AllToAll.apply(x, axis_name, mesh, split_axis, concat_axis)


def psum(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    """Sum over ``axes`` (differentiable; the backward is a ``psum``)."""
    for a in _axes(axes):
        x = _PSum.apply(x, a, mesh)
    return x


def pmean(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    n = 1
    for a in _axes(axes):
        n *= mesh.shape[a]
    return psum(x, axes, mesh) / n


def pmax(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    """Max over ``axes``; takes no gradient."""
    x = x.detach()
    for a in _axes(axes):
        x = _reduce(x, a, mesh, "MAX", "pmax")
    return x

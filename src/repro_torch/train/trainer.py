"""Train steps: gradient accumulation and the int8-compressed
data-parallel step, the port of ``repro.train.trainer``.

``make_train_step`` gives ``(state, batch) -> (state, metrics)`` for any
``loss_fn(params, batch) -> scalar``: gradients come from
``torch.autograd.grad`` over the parameter tree's leaves, microbatches run
one after another with their gradients summed in fp32 (the reference
scans them).  ``make_compressed_dp_step`` reduces the data-parallel
gradients in int8 with error feedback: over a rank mesh's data axis (each
rank its batch block, as the reference's ``shard_map`` step), or over
``n_shards`` shards of the batch run one after another in this process.
``make_sharded_train_step`` is the step of a cell's per-rank program:
parameters, moments and batch are this rank's blocks under their specs,
the gradient of each block is summed over the ranks that hold it and the
gradient norm is taken over every rank's blocks.

The optimizer updates its moments in place, so a state passed to a step
must not be used again; the step returns the state to go on with.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import axis_product, require_rank_mesh
from repro_torch.launch.sharding import (
    entry_axes, n_replicas, spec_leaves, sum_over_replicas,
)
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.train import optimizer as opt
from repro_torch.train.compression import (
    compressed_grad_reduce, compressed_grad_reduce_axis, init_error_feedback,
)

Params = Any


class TrainState(NamedTuple):
    params: Params
    opt_state: opt.AdamState
    ef: Optional[Params] = None      # error feedback (compressed DP only)


def init_train_state(params: Params, cfg: opt.AdamWConfig,
                     compressed_dp: bool = False,
                     n_shards: int = 1) -> TrainState:
    """``n_shards`` > 1 gives each error-feedback leaf a leading shard
    axis (see ``compression.init_error_feedback``)."""
    return TrainState(
        params=params,
        opt_state=opt.init_state(params, cfg),
        ef=init_error_feedback(params, n_shards) if compressed_dp else None,
    )


def value_and_grad(loss_fn: Callable, params: Params, batch
                   ) -> Tuple[torch.Tensor, Params]:
    """(detached loss, gradient tree shaped like ``params``)."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_fn(live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), tree_unflatten(params, grads)


def _split(batch, n: int) -> List:
    """``batch``'s tensors cut into ``n`` equal parts along dim 0."""
    parts = tree_map(lambda x: x.reshape(n, -1, *x.shape[1:]), batch)
    return [tree_map(lambda x: x[i], parts) for i in range(n)]


def make_train_step(loss_fn: Callable[[Params, Any], torch.Tensor],
                    cfg: opt.AdamWConfig,
                    grad_accum: int = 1) -> Callable:
    """The standard train step; ``grad_accum`` microbatches cut from the
    batch along dim 0, their fp32 gradients summed and averaged."""

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if grad_accum == 1:
            loss, grads = value_and_grad(loss_fn, state.params, batch)
        else:
            loss, grads = 0.0, None
            for mb in _split(batch, grad_accum):
                mb_loss, g = value_and_grad(loss_fn, state.params, mb)
                if grads is None:
                    grads = tree_map(lambda t: t.to(torch.float32), g)
                else:
                    for acc, t in zip(tree_leaves(grads), tree_leaves(g)):
                        acc.add_(t)
                loss = loss + mb_loss
                del g
            loss = loss / grad_accum
            for acc in tree_leaves(grads):
                acc.div_(grad_accum)
        newp, new_opt, info = opt.apply_updates(state.params, grads,
                                                state.opt_state, cfg)
        return TrainState(newp, new_opt, state.ef), {"loss": loss, **info}

    return step


def make_compressed_dp_step(loss_fn, cfg: opt.AdamWConfig,
                            n_shards: int = 1, mesh=None,
                            data_axis: str = "data") -> Callable:
    """Train step with an int8-compressed mean of the shards' gradients.

    With ``mesh`` (a rank mesh): each rank passes its block of the batch;
    parameters and optimizer state are replicated over ``data_axis``, each
    rank keeps its own error feedback (``init_train_state(...,
    compressed_dp=True)``) and the loss is the ``pmean``.  Without: the
    batch is cut into ``n_shards`` equal parts along dim 0, one a shard, in
    this process; the error feedback is per shard (``init_train_state(...,
    compressed_dp=True, n_shards=n_shards)``) and the loss is the shards'
    mean.  Both give the same parameters and error feedback."""
    if mesh is not None:
        require_rank_mesh(mesh, "make_compressed_dp_step")
        if n_shards != 1:
            raise ValueError("give a mesh or n_shards, not both")

        def group_step(state: TrainState, batch):
            loss, grads = value_and_grad(loss_fn, state.params, batch)
            red, new_ef = compressed_grad_reduce_axis(grads, state.ef,
                                                      data_axis, mesh)
            loss = C.pmean(loss, data_axis, mesh)
            newp, new_opt, info = opt.apply_updates(state.params, red,
                                                    state.opt_state, cfg)
            return TrainState(newp, new_opt, new_ef), {"loss": loss, **info}

        return group_step

    def step(state: TrainState, batch):
        if n_shards == 1:
            efs = [state.ef]
        else:
            efs = [tree_map(lambda e: e[i], state.ef)
                   for i in range(n_shards)]
        losses, grads = [], []
        for mb in _split(batch, n_shards):
            mb_loss, g = value_and_grad(loss_fn, state.params, mb)
            losses.append(mb_loss)
            grads.append(g)
        red, new_efs = compressed_grad_reduce(grads, efs)
        loss = sum(losses[1:], losses[0]) / float(n_shards)
        newp, new_opt, info = opt.apply_updates(state.params, red,
                                                state.opt_state, cfg)
        if n_shards == 1:
            new_ef = new_efs[0]
        else:
            new_ef = tree_unflatten(state.ef, [
                torch.stack(shard) for shard in zip(
                    *(tree_leaves(e) for e in new_efs))])
        return TrainState(newp, new_opt, new_ef), {"loss": loss, **info}

    return step


def _wide_leaves(cfg: opt.AdamWConfig, param_specs, state_specs
                 ) -> List[Tuple[str, ...]]:
    """For each parameter, the axes its last dim is split over that its
    8-bit moment's block dim is not (the rules leave a block count that
    does not divide whole): such a leaf is updated gathered along its last
    dim, against the moment every rank holds whole there."""
    p_specs = spec_leaves(param_specs)
    if cfg.state_bits != 8:
        return [()] * len(p_specs)
    q_specs = spec_leaves(state_specs.opt_state.m)[0::2]
    out = []
    for p_sp, q_sp in zip(p_specs, q_specs):
        last = entry_axes(p_sp[-1]) if p_sp else ()
        nb = entry_axes(q_sp[-2]) if len(q_sp) >= 2 else ()
        if last and tuple(nb) != tuple(last):
            if nb:
                raise ValueError(f"a parameter split {p_sp} with its 8-bit "
                                 f"moment split {q_sp}: no per-rank update")
            out.append(last)
        else:
            out.append(())
    return out


def make_sharded_train_step(loss_fn: Callable[[Params, Any], torch.Tensor],
                            cfg: opt.AdamWConfig, mesh, param_specs,
                            state_specs=None) -> Callable:
    """A rank's train step over a rank mesh.

    ``loss_fn(params, batch)`` takes this rank's blocks and returns the
    global loss, equal on every rank.  Its gradient divided by the mesh
    size, summed over the axes a leaf is replicated on
    (``sharding.sum_over_replicas``), is each block's gradient of the
    global loss; the clip norm sums every block's squares once
    (``n_replicas``) over the mesh.  ``state_specs`` (a ``TrainState`` of
    specs) is needed for 8-bit moments (:func:`_wide_leaves`).  ``mesh``
    may be a shape-only mesh until the step is called."""
    from repro_torch.graphops.distributed import flat_axis_index
    sps = spec_leaves(param_specs)
    wide = _wide_leaves(cfg, param_specs, state_specs)
    axes = tuple(mesh.axis_names)

    def widen(x, ax):
        return C.all_gather(x, ax, mesh, axis=x.dim() - 1) if ax else x

    def narrow(x, ax):
        if not ax:
            return x
        n = x.shape[-1] // axis_product(mesh, ax)
        return x.narrow(x.dim() - 1, flat_axis_index(ax, mesh) * n,
                        n).clone()

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        require_rank_mesh(mesh, "make_sharded_train_step")
        live = tree_map(lambda t: t.detach().requires_grad_(), state.params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            loss = loss_fn(live, batch)
            grads = torch.autograd.grad(loss / mesh.size, leaves)
        grads = [sum_over_replicas(g, sp, mesh) for g, sp in zip(grads, sps)]
        with torch.no_grad():
            sq = sum(torch.sum(torch.square(g.to(torch.float32)))
                     / n_replicas(sp, mesh) for g, sp in zip(grads, sps))
            gnorm = torch.sqrt(C.psum(sq, axes, mesh))
            params = [widen(p.detach(), ax) for p, ax in
                      zip(tree_leaves(state.params), wide)]
            grads = [widen(g, ax) for g, ax in zip(grads, wide)]
            newp, new_opt, info = opt.apply_updates(
                tree_unflatten(state.params, params),
                tree_unflatten(state.params, grads), state.opt_state, cfg,
                gnorm=gnorm)
            newp = tree_unflatten(state.params, [
                narrow(p, ax) for p, ax in zip(tree_leaves(newp), wide)])
        return TrainState(newp, new_opt, None), {"loss": loss.detach(),
                                                 **info}

    return step

"""Expert-parallel MoE layer over a rank mesh (all-to-all dispatch), the
port of ``repro.models.moe_sharded``.

The reference writes the collective schedule by hand inside ``shard_map``;
here each rank runs that body on its own blocks:

  1. tokens are sharded over the data axes; each model-axis peer takes a
     distinct 1/mp slice of the local tokens (or, ``seq_sharded``, holds
     only its sequence slice),
  2. local top-k routing + stable sort dispatch into [E, C_loc, D], with
     ``C_loc = max(int(T_loc * K * capacity_factor / E), 4)``: each peer
     drops tokens by its own capacity,
  3. all-to-all over the model axis: each peer keeps its E/mp experts and
     receives every peer's rows for them -> [E/mp, mp * C_loc, D],
  4. expert weights are ZeRO-3-sharded over data ([E/mp, D/dp, F] and
     [E/mp, F/dp, D], spec (model, data, None)) and all-gathered just in
     time,
  5. grouped expert GEMMs, reverse all-to-all, local combine, and an
     all-gather of the token slices over the model axis (none when
     ``seq_sharded``).

Differentiable end to end: the collectives' backward passes are the
mirrored schedule.  The aux loss is the ``pmean`` over the mesh of each
peer's load-balance loss over its own tokens.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import Mesh, axis_product, require_rank_mesh
from repro_torch.models.common import Params
from repro_torch.models.moe import (
    MoEConfig, _mask_padded, expert_counts, log_routing,
)


def local_capacity(T_loc: int, cfg: MoEConfig) -> int:
    """Each peer's slots per expert (the reference's truncation)."""
    return max(int(T_loc * cfg.top_k * cfg.capacity_factor / cfg.e_alloc), 4)


def _local_dispatch(xt: torch.Tensor, router_w: torch.Tensor,
                    cfg: MoEConfig, C_loc: int):
    """Local routing + sort dispatch.  xt: [T_loc, D] -> buf [E, C_loc, D]."""
    T_loc, D = xt.shape
    E, K = cfg.e_alloc, cfg.top_k
    dev = xt.device
    logits = _mask_padded((xt @ router_w).to(torch.float32), cfg)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)
    log_routing(gate_idx, logits)
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    TK = T_loc * K
    flat_e = gate_idx.reshape(TK)
    flat_t = torch.arange(TK, device=dev) // K
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = expert_counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(TK, device=dev) - starts[sorted_e]
    keep = pos < C_loc
    slot = torch.where(keep, sorted_e * C_loc + pos, E * C_loc - 1)
    gathered = torch.where(keep[:, None], xt[flat_t[order]], 0)
    buf = xt.new_zeros((E * C_loc, D)).index_add(0, slot, gathered)
    meta = (order, slot, keep, flat_t, gate_vals.reshape(TK), counts, probs)
    return buf.reshape(E, C_loc, D), meta


def _aux(meta, cfg: MoEConfig, T_loc: int, mesh: Mesh, data_axes,
         model_axis: str) -> torch.Tensor:
    counts, probs = meta[-2], meta[-1]
    E, K = cfg.n_experts, cfg.top_k  # aux over REAL experts only
    frac = counts.to(torch.float32) / float(T_loc * K)
    aux = cfg.router_aux_weight * E * torch.sum(
        frac * torch.mean(probs, dim=0)) * K
    return C.pmean(aux, tuple(data_axes) + (model_axis,), mesh)


def _shared(p: Params, xt: torch.Tensor) -> torch.Tensor:
    sh = p["shared"]
    return (F.silu(xt @ sh["wg"]) * (xt @ sh["wi"])) @ sh["wo"]


def moe_apply_sharded(p: Params, x: torch.Tensor, cfg: MoEConfig,
                      mesh: Mesh, data_axes: Tuple[str, ...] = ("data",),
                      model_axis: str = "model",
                      weight_axes: Optional[Tuple[str, ...]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's blocks in and out.

    x: [B/dp, S, D] (batch sharded over ``data_axes``, replicated over the
    model axis), or [B/dp, S/mp, D] with ``cfg.seq_sharded``.  ``p``:
    ``router.w`` and ``shared`` replicated, ``wi``/``wg`` blocks
    [E/mp, D/dp, F] and ``wo`` [E/mp, F/dp, D] (spec (model, data_axes,
    None), launch/sharding.py).  ``weight_axes``: the axes the experts'
    dim 1 is split over, when not ``data_axes`` (the rules split weights
    over "data" alone: on a multi-pod mesh they are whole over "pod").
    Returns (out block shaped like ``x``, the aux loss, equal on every
    rank)."""
    require_rank_mesh(mesh, "moe_apply_sharded")
    data_axes = tuple(data_axes)
    Bl, Sl, D = x.shape
    E, mp = cfg.e_alloc, mesh.shape[model_axis]
    if E % mp:
        raise ValueError(f"{E} experts do not split over {mp} model peers "
                         f"(pad them with n_experts_alloc)")
    if cfg.seq_sharded:
        T_loc = Bl * Sl
        xt_m, xt = x.reshape(T_loc, D), None
    else:
        T_l = Bl * Sl
        if T_l % mp:
            raise ValueError(f"{T_l} local tokens do not split over {mp} "
                             f"model peers")
        T_loc = T_l // mp
        xt = x.reshape(T_l, D)
        m_idx = C.axis_index(model_axis, mesh)
        xt_m = xt[m_idx * T_loc:(m_idx + 1) * T_loc]
    C_loc = local_capacity(T_loc, cfg)
    buf, meta = _local_dispatch(xt_m, p["router"]["w"], cfg, C_loc)
    # [E, C_loc, D] -> [E/mp, mp*C_loc, D]: my experts, every peer's rows
    xe = C.all_to_all(buf, model_axis, mesh, split_axis=0, concat_axis=1)
    # ZeRO-3 just-in-time weight gather over the data axes
    wax = data_axes if weight_axes is None else tuple(weight_axes)
    wi, wg, wo = (C.all_gather(p[n], wax, mesh, axis=1) if wax else p[n]
                  for n in ("wi", "wg", "wo"))
    h = torch.einsum("ecd,edf->ecf", xe, wi)
    g = torch.einsum("ecd,edf->ecf", xe, wg)
    ye = torch.einsum("ecf,efd->ecd", F.silu(g) * h, wo)
    # reverse exchange: [E/mp, mp*C_loc, D] -> [E, C_loc, D] (my tokens)
    ye = C.all_to_all(ye, model_axis, mesh, split_axis=1, concat_axis=0)
    order, slot, keep, flat_t, flat_g, _, _ = meta
    gate = (flat_g[order] * keep)[:, None].to(ye.dtype)
    contrib = ye.reshape(E * C_loc, D)[slot] * gate
    out_m = x.new_zeros((T_loc, D)).index_add(0, flat_t[order], contrib)
    aux = _aux(meta, cfg, T_loc, mesh, data_axes, model_axis)
    if cfg.seq_sharded:
        if "shared" in p:
            out_m = out_m + _shared(p, xt_m)
        return out_m.reshape(Bl, Sl, D), aux
    out = C.all_gather(out_m, model_axis, mesh, axis=0)
    if "shared" in p:
        out = out + _shared(p, xt)
    return out.reshape(Bl, Sl, D), aux


def expert_spec(data_axes: Tuple[str, ...] = ("data",),
                model_axis: str = "model") -> tuple:
    """The spec of one layer's ``wi``/``wg``/``wo`` under this layer."""
    d = tuple(data_axes)
    return (model_axis, d[0] if len(d) == 1 else d, None)



def moe_apply_pjit(p: Params, x: torch.Tensor, cfg: MoEConfig, mesh: Mesh,
                   token_axes: Sequence[str] = (), model_axis: str = "model"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dispatch_pspec = (ep, dspec, None)`` over a rank mesh: the
    single-device layer's result (its capacity and drops over every token
    of the batch) from this rank's tokens, with no all-to-all.

    x: [B_l, S, D], this rank's tokens: a contiguous block of the global
    token order over ``token_axes`` (every token when it is empty).
    ``p``: ``router`` and ``shared`` whole; with ``ep = "model"`` the
    experts' blocks [E/mp, D, F] and [E/mp, F, D] (each model rank runs
    its experts), with ``ep = None`` [E, D, F/mp] and [E, F/mp, D]
    (tensor-parallel experts, as the rules split 60 experts over 16).
    Each rank's slot positions are its tokens' places in their experts'
    global queues (the counts of the ranks before it, all-gathered), so
    the same tokens drop; the partial outputs are summed over the model
    axis.  Returns (out [B_l, S, D], the global aux loss)."""
    require_rank_mesh(mesh, "dispatch_pspec")
    ep = cfg.dispatch_pspec[0]
    if ep not in (None, model_axis):
        raise ValueError(f"dispatch_pspec {cfg.dispatch_pspec}: the expert "
                         f"axis is the model axis or None")
    token_axes = tuple(token_axes)
    Bl, Sl, D = x.shape
    T_l = Bl * Sl
    T = T_l * axis_product(mesh, token_axes)
    E, K = cfg.e_alloc, cfg.top_k
    mp, m = mesh.shape[model_axis], C.axis_index(model_axis, mesh)
    dev = x.device
    Cap = max(int(T * K * cfg.capacity_factor / E), 1)
    xt = x.reshape(T_l, D)
    logits = _mask_padded((xt @ p["router"]["w"]).to(torch.float32), cfg)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)
    log_routing(gate_idx, logits)
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    TK = T_l * K
    flat_e = gate_idx.reshape(TK)
    flat_t = torch.arange(TK, device=dev) // K
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = expert_counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(TK, device=dev) - starts[sorted_e]
    prob_sum = torch.sum(probs, dim=0)
    if token_axes:
        from repro_torch.graphops.distributed import flat_axis_index
        every = C.all_gather(counts[None], token_axes, mesh, axis=0)
        before = (torch.cumsum(every, 0) - every)[
            flat_axis_index(token_axes, mesh)]
        pos = pos + before[sorted_e]
        counts = torch.sum(every, 0)
        prob_sum = C.psum(prob_sum, token_axes, mesh)
    keep = pos < Cap
    if ep == model_axis:
        if E % mp:
            raise ValueError(f"{E} experts do not split over {mp} model "
                             f"ranks")
        El = E // mp
        e_loc = sorted_e - m * El
        keep = keep & (e_loc >= 0) & (e_loc < El)
        slot = torch.where(keep, e_loc * Cap + pos, El * Cap - 1)
    else:
        El = E
        slot = torch.where(keep, sorted_e * Cap + pos, E * Cap - 1)
    tok = flat_t[order]
    gathered = torch.where(keep[:, None], xt[tok], 0)
    xe = xt.new_zeros((El * Cap, D)).index_add(0, slot, gathered).reshape(
        El, Cap, D)
    h = torch.einsum("ecd,edf->ecf", xe, p["wi"])
    g = torch.einsum("ecd,edf->ecf", xe, p["wg"])
    ye = torch.einsum("ecf,efd->ecd", F.silu(g) * h, p["wo"])
    gate = (gate_vals.reshape(TK)[order] * keep)[:, None].to(ye.dtype)
    contrib = ye.reshape(El * Cap, D)[slot] * gate
    out = C.psum(x.new_zeros((T_l, D)).index_add(0, tok, contrib),
                 model_axis, mesh)
    if "shared" in p:
        out = out + _shared(p, xt)
    frac = counts.to(torch.float32) / float(T * K)
    aux = cfg.router_aux_weight * E * torch.sum(frac * prob_sum / T) * K
    return out.reshape(Bl, Sl, D), aux

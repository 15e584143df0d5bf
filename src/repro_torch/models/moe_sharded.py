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

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import Mesh, require_rank_mesh
from repro_torch.models.common import Params
from repro_torch.models.moe import MoEConfig, _mask_padded


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
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    TK = T_loc * K
    flat_e = gate_idx.reshape(TK)
    flat_t = torch.arange(TK, device=dev) // K
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)
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
                      model_axis: str = "model"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's blocks in and out.

    x: [B/dp, S, D] (batch sharded over ``data_axes``, replicated over the
    model axis), or [B/dp, S/mp, D] with ``cfg.seq_sharded``.  ``p``:
    ``router.w`` and ``shared`` replicated, ``wi``/``wg`` blocks
    [E/mp, D/dp, F] and ``wo`` [E/mp, F/dp, D] (spec (model, data_axes,
    None), launch/sharding.py).  Returns (out block shaped like ``x``, the
    aux loss, equal on every rank)."""
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
    wi = C.all_gather(p["wi"], data_axes, mesh, axis=1)
    wg = C.all_gather(p["wg"], data_axes, mesh, axis=1)
    wo = C.all_gather(p["wo"], data_axes, mesh, axis=1)
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


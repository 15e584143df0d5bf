"""Mixture-of-Experts FFN on one device, the port of ``repro.models.moe``.

Sort-based capacity dispatch (GShard-style capacity, MegaBlocks-style
sort): token->expert assignments are sorted by expert with a stable sort,
positions within each expert's buffer come from exclusive-cumsum offsets,
and tokens scatter into a dense [E*C, D] buffer for the grouped expert
GEMMs.  Tokens past an expert's capacity are dropped: the stable sort keeps
the reference's choice of which.  Shared experts (Qwen-MoE) are always
active; a Switch-style load-balancing loss comes back beside the output.
Experts padded up to ``n_experts_alloc`` are masked out of the router.
With ``mesh`` (a rank mesh) the layer is the expert-parallel one of
``moe_sharded.py``.  While :data:`routing_log` is a list, every routing
(this layer's and the sharded ones') appends its top-k expert indices and
fp32 router logits to it, for checks that hold two runs' routing apart
at near ties.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, dense_init, randn
from repro_torch.utils.device import DeviceLike


routing_log: Optional[list] = None


def log_routing(gate_idx: torch.Tensor, logits: torch.Tensor) -> None:
    if routing_log is not None:
        routing_log.append((gate_idx.detach(), logits.detach()))


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0       # shared width: n_shared * d_ff_expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # a spec (ep, batch axes, None) for the dispatched [E, C, D] buffer
    # over the ambient mesh; over a rank mesh its per-rank program is
    # moe_sharded.moe_apply_pjit (each model rank its experts, or its
    # slice of every expert's d_ff, then a psum)
    dispatch_pspec: Optional[tuple] = None
    # a rank mesh (launch/mesh.py) routes the layer through the explicit
    # expert-parallel layer (moe_sharded.py)
    mesh: object = None
    data_axes: tuple = ("data",)
    model_axis: str = "model"
    # sequence-parallel integration: the layer input/output stay S-sharded
    # over the model axis (no per-layer slice/gather collectives)
    seq_sharded: bool = False
    # allocated expert count (>= n_experts): pads the expert axis; the
    # router masks padded experts so they never receive tokens
    n_experts_alloc: int = 0

    @property
    def e_alloc(self) -> int:
        return self.n_experts_alloc or self.n_experts


def _mask_padded(logits: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    if cfg.e_alloc == cfg.n_experts:
        return logits
    idx = torch.arange(cfg.e_alloc, device=logits.device)
    return torch.where(idx[None, :] < cfg.n_experts, logits, -1e30)


def expert_counts(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Slots routed to each expert, int64 [E]: ``bincount`` with a
    known length, as a scatter-add (which also runs on meta tensors)."""
    return torch.zeros(E, dtype=torch.int64, device=flat_e.device
                       ).scatter_add_(0, flat_e, torch.ones_like(flat_e))


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32, device: DeviceLike = None,
             lead: tuple = ()) -> Params:
    """``lead`` stacks independent layers along leading axes."""
    E, Fe = cfg.e_alloc, cfg.d_ff_expert
    s_in = 1.0 / (d_model ** 0.5)
    s_out = 1.0 / (Fe ** 0.5)

    def w(shape, scale):
        return randn(gen, (*lead, *shape), dtype, device).mul_(scale)

    p = {
        "router": dense_init(gen, d_model, E, scale=s_in, dtype=dtype,
                             device=device, lead=lead),
        "wi": w((E, d_model, Fe), s_in),
        "wg": w((E, d_model, Fe), s_in),
        "wo": w((E, Fe, d_model), s_out),
    }
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        p["shared"] = {"wi": w((d_model, Fs), s_in),
                       "wg": w((d_model, Fs), s_in),
                       "wo": w((Fs, d_model), s_out)}
    return p


def moe_apply(p: Params, x: torch.Tensor, cfg: MoEConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux_loss fp32 scalar); with
    ``cfg.mesh``, this rank's blocks (see ``moe_sharded``)."""
    if cfg.dispatch_pspec is not None:
        raise TypeError(
            "dispatch_pspec names the axes of a rank mesh: run the layer "
            "through moe_sharded.moe_apply_pjit with the mesh (the "
            "transformer's decode step over a rank mesh does)")
    if cfg.mesh is not None:
        from repro_torch.models.moe_sharded import moe_apply_sharded
        return moe_apply_sharded(p, x, cfg, cfg.mesh, cfg.data_axes,
                                 cfg.model_axis)
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    E, K = cfg.e_alloc, cfg.top_k
    dev = x.device

    logits = (xt @ p["router"]["w"]).to(torch.float32)       # [T, E]
    logits = _mask_padded(logits, cfg)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)        # [T, K]
    log_routing(gate_idx, logits)
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)

    C = max(int(T * K * cfg.capacity_factor / E), 1)
    TK = T * K
    flat_e = gate_idx.reshape(TK)                             # expert per slot
    flat_t = torch.arange(TK, device=dev) // K                # token per slot
    flat_g = gate_vals.reshape(TK)

    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = expert_counts(flat_e, E)                         # [E]
    starts = torch.cumsum(counts, 0) - counts                 # exclusive
    pos = torch.arange(TK, device=dev) - starts[sorted_e]     # pos in expert
    keep = pos < C
    # dropped tokens add zeros into the clamped last slot (no overflow row)
    slot = torch.where(keep, sorted_e * C + pos, E * C - 1)
    tok = flat_t[order]
    gathered = torch.where(keep[:, None], xt[tok], 0)
    buf = x.new_zeros((E * C, D)).index_add(0, slot, gathered)
    xe = buf.reshape(E, C, D)

    h = torch.einsum("ecd,edf->ecf", xe, p["wi"])
    g = torch.einsum("ecd,edf->ecf", xe, p["wg"])
    ye = torch.einsum("ecf,efd->ecd", F.silu(g) * h, p["wo"])

    gate = (flat_g[order] * keep)[:, None].to(ye.dtype)
    contrib = ye.reshape(E * C, D)[slot] * gate
    out = x.new_zeros((T, D)).index_add(0, tok, contrib)

    if "shared" in p:
        sh = p["shared"]
        hs = F.silu(xt @ sh["wg"]) * (xt @ sh["wi"])
        out = out + hs @ sh["wo"]

    # Switch-style load-balance loss: E * sum_e f_e * P_e
    frac = counts.to(torch.float32) / float(TK)
    prob = torch.mean(probs, dim=0)
    aux = cfg.router_aux_weight * E * torch.sum(frac * prob) * K
    return out.reshape(B, S, D), aux

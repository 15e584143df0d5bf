"""DimeNet: directional message passing [arXiv:2003.03123], the port of
``repro.models.gnn.dimenet``.

Messages live on *edges*; each interaction block aggregates over the
triplet list (k -> j -> i) with a spherical-Bessel × Legendre angular basis
and a bilinear contraction (n_bilinear low-rank).  The triplet list is the
materialized 2-hop view produced by ``graphdata.build_triplets``.  The
reference's ``jax.ops.segment_sum`` is ``graphdata.scatter``
(``index_add`` into zeros of the segment count).  Node- and edge-indexed
reads and sums go through ``graphdata.rows`` / ``scatter`` / ``pool``, so
a batch split by rows over a rank mesh (``GraphBatch.partition``) runs
the same code on a rank's blocks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    Params, dense, dense_init, gather_rows, mlp, mlp_init, randn,
)
from repro_torch.models.gnn.graphdata import GraphBatch, pool, rows, scatter
from repro_torch.models.gnn.radial import (
    bessel_rbf, poly_envelope, safe_norm, spherical_basis,
)
from repro_torch.utils.device import DeviceLike


@dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_types: int = 16                # atom-type vocabulary
    d_in: int = 0                    # >0: continuous node features (non-mol)
    n_out: int = 1                   # 1 = energy; >1 = node classes
    graph_level: bool = True
    n_graphs: int = 1
    dtype: Any = torch.float32


def init_params(gen: torch.Generator, cfg: DimeNetConfig,
                device: DeviceLike = None) -> Params:
    h = cfg.d_hidden
    S = cfg.n_spherical * cfg.n_radial
    kw = {"dtype": cfg.dtype, "device": device}
    blocks = []
    for _ in range(cfg.n_blocks):
        blocks.append({
            "rbf_proj": dense_init(gen, cfg.n_radial, h, **kw),
            "down": dense_init(gen, h, cfg.n_bilinear, **kw),
            "bilinear": randn(gen, (S, cfg.n_bilinear, h), cfg.dtype,
                              device) / (S ** 0.5),
            "update": mlp_init(gen, [h, h, h], **kw),
            "out_proj": dense_init(gen, h, h, **kw),
        })
    if cfg.d_in:
        embed0 = dense_init(gen, cfg.d_in, h, **kw)
    else:
        embed0 = {"w": randn(gen, (cfg.n_types, h), cfg.dtype, device)
                  * 0.05}
    return {
        "embed": embed0,
        "blocks": blocks,
        "rbf_emb": dense_init(gen, cfg.n_radial, h, **kw),
        "msg_init": mlp_init(gen, [3 * h, h], **kw),
        "head": mlp_init(gen, [h, h, cfg.n_out], **kw),
    }


def forward(params: Params, gb: GraphBatch, cfg: DimeNetConfig,
            triplets=None) -> torch.Tensor:
    """triplets: (t_in, t_out, t_mask) from build_triplets, as tensors on
    the batch's device; required."""
    assert gb.positions is not None, "DimeNet needs positions"
    t_in, t_out, t_mask = triplets
    src, dst = gb.edge_src, gb.edge_dst
    pos = gb.positions.to(cfg.dtype)
    d_vec = rows(gb, pos, dst) - rows(gb, pos, src)
    r = safe_norm(d_vec)
    rbf = bessel_rbf(r, cfg.n_radial, cfg.cutoff)
    rbf = rbf * poly_envelope(r, cfg.cutoff)[:, None]

    if cfg.d_in:
        hnode = dense(params["embed"], gb.node_feat.to(cfg.dtype))
    else:
        hnode = gather_rows(params["embed"]["w"], gb.node_feat)
    e_rbf = dense(params["rbf_emb"], rbf)
    m = mlp(params["msg_init"],
            torch.cat([rows(gb, hnode, src), rows(gb, hnode, dst),
                       e_rbf], dim=-1),
            act=F.silu)                                         # [E, h]
    m = m * gb.edge_mask[:, None]

    # triplet geometry: angle at j between (k - j) and (i - j), the
    # reference's pos[src[t]] - pos[dst[t]] and pos[dst[t]] - pos[src[t]]
    # read off the edge vectors (equal bit for bit)
    v_in = -rows(gb, d_vec, t_in)           # k - j  (edge t_in is k->j)
    v_out = rows(gb, d_vec, t_out)          # i - j  (edge t_out is j->i)
    cos = torch.sum(v_in * v_out, -1) / torch.clamp(
        safe_norm(v_in) * safe_norm(v_out), min=1e-9)
    r_in = safe_norm(v_in)
    sbf = spherical_basis(r_in, torch.clamp(cos, -1.0, 1.0),
                          cfg.n_spherical, cfg.n_radial, cfg.cutoff)  # [T, S]
    sbf = sbf * t_mask[:, None]
    return _run_blocks(params, m, rbf, sbf, t_in, t_out, gb, cfg)


def _run_blocks(params, m, rbf, sbf, t_in, t_out, gb, cfg):
    n = gb.n_nodes
    per_node = torch.zeros((n, cfg.d_hidden), dtype=cfg.dtype,
                           device=m.device)
    for blk in params["blocks"]:
        gate = dense(blk["rbf_proj"], rbf)                     # [E, h]
        x_kj = rows(gb, m, t_in) * rows(gb, gate, t_in)        # [T, h]
        low = dense(blk["down"], x_kj)                         # [T, nb]
        tri = torch.einsum("ts,tn,snh->th", sbf, low, blk["bilinear"])
        agg = scatter(gb, tri, t_out, m.shape[0])              # [E, h]
        m = m + mlp(blk["update"], agg, act=F.silu)
        m = m * gb.edge_mask[:, None]
        per_node = per_node + scatter(
            gb, dense(blk["out_proj"], m), gb.edge_dst, n)
    out = mlp(params["head"], per_node, act=F.silu)
    if cfg.graph_level:
        return pool(gb, out * gb.node_mask[:, None], gb.graph_id,
                    cfg.n_graphs)
    return out


def energy_loss(params: Params, gb: GraphBatch, cfg: DimeNetConfig,
                triplets, targets: torch.Tensor) -> torch.Tensor:
    e = forward(params, gb, cfg, triplets)[..., 0]
    return torch.mean((e - targets) ** 2)

"""MACE: higher-order equivariant message passing [arXiv:2206.07697], the
port of ``repro.models.gnn.mace``.

Each layer builds the one-particle A-basis (NequIP-style edge
tensor-product aggregation), then the higher-order B-basis by channel-wise
CG self-products up to ``correlation_order`` (A, A⊗A, (A⊗A)⊗A), linearly
recombined into messages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    Params, gather_rows, mlp, mlp_init, randn,
)
from repro_torch.models.gnn.graphdata import GraphBatch, pool, rows
from repro_torch.models.gnn.irreps import (
    IrrepFeat, cg_tensor, irrep_linear, irrep_linear_init, norm_squared,
    spherical_harmonics, valid_paths,
)
from repro_torch.models.gnn.nequip import edge_messages
from repro_torch.models.gnn.radial import bessel_rbf, poly_envelope, safe_norm
from repro_torch.utils.device import DeviceLike


@dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    n_types: int = 16
    n_graphs: int = 1
    dtype: Any = torch.float32

    @property
    def ls(self) -> Tuple[int, ...]:
        return tuple(range(self.l_max + 1))


def _edge_paths(cfg: MACEConfig):
    return valid_paths(cfg.ls, cfg.ls, cfg.ls)


def _product_paths(cfg: MACEConfig):
    """Channel-wise CG paths for A (x) A -> l3."""
    return valid_paths(cfg.ls, cfg.ls, cfg.ls)


def init_params(gen: torch.Generator, cfg: MACEConfig,
                device: DeviceLike = None) -> Params:
    M = cfg.d_hidden
    ep = _edge_paths(cfg)
    kw = {"dtype": cfg.dtype, "device": device}
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "radial": mlp_init(gen, [cfg.n_rbf, 32, len(ep) * M], **kw),
            # one linear recombination per correlation order
            "combine": [irrep_linear_init(gen, cfg.ls, M, M, **kw)
                        for _ in range(cfg.correlation_order)],
            "self": irrep_linear_init(gen, cfg.ls, M, M, **kw),
        })
    return {
        "embed": randn(gen, (cfg.n_types, M), cfg.dtype, device) * 0.5,
        "layers": layers,
        "head": mlp_init(gen, [M * (cfg.l_max + 1), 64, 1], **kw),
    }


def _a_basis(lp, h, sh, rbf, gb, cfg) -> IrrepFeat:
    """One-particle basis: aggregate weighted (h_src ⊗ Y) per destination."""
    paths = _edge_paths(cfg)
    w = mlp(lp["radial"], rbf, act=F.silu) * gb.edge_mask[:, None]
    w = w.reshape(-1, len(paths), cfg.d_hidden)
    return edge_messages(w, h, sh, gb, paths)


def _channel_product(a: IrrepFeat, b: IrrepFeat, cfg: MACEConfig
                     ) -> IrrepFeat:
    """Channel-wise CG product (same multiplicity index on both sides)."""
    out: IrrepFeat = {}
    for (l1, l2, l3) in _product_paths(cfg):
        if l1 not in a or l2 not in b:
            continue
        x = a[l1]
        C = cg_tensor(l1, l2, l3, x.dtype, x.device)
        term = torch.einsum("nmi,nmj,ijk->nmk", x, b[l2], C)
        out[l3] = out[l3] + term if l3 in out else term
    return out


def forward(params: Params, gb: GraphBatch, cfg: MACEConfig
            ) -> torch.Tensor:
    """Per-graph energies [n_graphs]."""
    assert gb.positions is not None
    pos = gb.positions.to(cfg.dtype)
    d_vec = rows(gb, pos, gb.edge_dst) - rows(gb, pos, gb.edge_src)
    r = safe_norm(d_vec)
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff) \
        * poly_envelope(r, cfg.cutoff)[:, None]
    sh = spherical_harmonics(d_vec, cfg.l_max)

    M = cfg.d_hidden
    N = gb.n_nodes

    def zeros(l):
        return torch.zeros((N, M, 2 * l + 1), dtype=cfg.dtype,
                           device=pos.device)

    h: IrrepFeat = {
        0: gather_rows(params["embed"], gb.node_feat)[:, :, None]}
    for l in range(1, cfg.l_max + 1):
        h[l] = zeros(l)

    for lp in params["layers"]:
        A = _a_basis(lp, h, sh, rbf, gb, cfg)
        for l in range(cfg.l_max + 1):
            A.setdefault(l, zeros(l))
        # B-basis: correlation products A, A⊗A, (A⊗A)⊗A ...
        msg: IrrepFeat = {}
        B = A
        for c in range(cfg.correlation_order):
            contrib = irrep_linear(lp["combine"][c], B)
            for l, x in contrib.items():
                msg[l] = msg[l] + x if l in msg else x
            if c + 1 < cfg.correlation_order:
                B = _channel_product(B, A, cfg)
                for l in range(cfg.l_max + 1):
                    B.setdefault(l, zeros(l))
        self_part = irrep_linear(lp["self"], h)
        h = {l: torch.tanh(msg[l]) if l == 0 else msg[l] for l in msg}
        h = {l: h[l] + self_part[l] for l in h}
        h = {l: x * gb.node_mask[:, None, None] for l, x in h.items()}

    inv = norm_squared(h)
    e_atom = mlp(params["head"], inv, act=F.silu)[:, 0] * gb.node_mask
    return pool(gb, e_atom, gb.graph_id, cfg.n_graphs)


def energy_loss(params: Params, gb: GraphBatch, cfg: MACEConfig,
                targets: torch.Tensor) -> torch.Tensor:
    e = forward(params, gb, cfg)
    return torch.mean((e - targets) ** 2)

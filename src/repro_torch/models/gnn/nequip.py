"""NequIP: E(3)-equivariant interatomic potentials [arXiv:2101.03164], the
port of ``repro.models.gnn.nequip``.

Node features are irrep stacks {l: [N, M, 2l+1]}; each interaction layer
computes per-edge weighted CG tensor products of (source features ⊗ edge
spherical harmonics) with radial-MLP path weights, scatter-sums to
destinations, and applies an equivariant linear + gated nonlinearity.
Readout: invariant scalars -> per-atom energy -> graph sum.  Energy is
rotation-invariant; forces (-dE/dpos, by autograd) are equivariant.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    Params, gather_rows, mlp, mlp_init, randn,
)
from repro_torch.models.gnn.graphdata import GraphBatch, pool, rows, scatter
from repro_torch.models.gnn.irreps import (
    IrrepFeat, cg_tensor, gate, irrep_linear, irrep_linear_init,
    norm_squared, spherical_harmonics, valid_paths,
)
from repro_torch.models.gnn.radial import bessel_rbf, poly_envelope, safe_norm
from repro_torch.utils.device import DeviceLike


@dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32          # multiplicity per l
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_types: int = 16
    n_graphs: int = 1
    dtype: Any = torch.float32

    @property
    def ls(self) -> Tuple[int, ...]:
        return tuple(range(self.l_max + 1))


def _paths(cfg: NequIPConfig):
    return valid_paths(cfg.ls, cfg.ls, cfg.ls)


def init_params(gen: torch.Generator, cfg: NequIPConfig,
                device: DeviceLike = None) -> Params:
    M = cfg.d_hidden
    paths = _paths(cfg)
    kw = {"dtype": cfg.dtype, "device": device}
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "radial": mlp_init(gen, [cfg.n_rbf, 32, len(paths) * M], **kw),
            "self": irrep_linear_init(gen, cfg.ls, M, M, **kw),
            "mix": irrep_linear_init(gen, cfg.ls, M, M, **kw),
        })
    return {
        "embed": randn(gen, (cfg.n_types, M), cfg.dtype, device) * 0.5,
        "layers": layers,
        "head": mlp_init(gen, [M * (cfg.l_max + 1), 32, 1], **kw),
    }


def edge_messages(w: torch.Tensor, h: IrrepFeat, sh: IrrepFeat,
                  gb: GraphBatch, paths) -> IrrepFeat:
    """Σ over paths of w[:, path] ⊙ CG(h[src]^{l1}, Y^{l2}) per edge,
    scatter-summed to the destinations: {l3: [N, M, 2l3+1]}."""
    feat_src = {l: rows(gb, x, gb.edge_src) for l, x in h.items()}
    msg: IrrepFeat = {}
    for pi, (l1, l2, l3) in enumerate(paths):
        x = feat_src[l1]
        C = cg_tensor(l1, l2, l3, x.dtype, x.device)
        term = torch.einsum("emi,euj,ijk->emk", x, sh[l2], C)
        term = term * w[:, pi, :, None]
        msg[l3] = msg[l3] + term if l3 in msg else term
    return {l: scatter(gb, x, gb.edge_dst, gb.n_nodes)
            for l, x in msg.items()}


def _interaction(lp: Params, h: IrrepFeat, sh: IrrepFeat,
                 rbf: torch.Tensor, gb: GraphBatch, cfg: NequIPConfig
                 ) -> IrrepFeat:
    paths = _paths(cfg)
    w_all = mlp(lp["radial"], rbf, act=F.silu)                 # [E, P*M]
    w_all = w_all * gb.edge_mask[:, None]
    w_all = w_all.reshape(-1, len(paths), cfg.d_hidden)
    agg = edge_messages(w_all, h, sh, gb, paths)
    out = {}
    self_part = irrep_linear(lp["self"], h)
    mix_part = irrep_linear(lp["mix"], agg)
    for l in h:
        out[l] = self_part[l] + mix_part.get(l, torch.zeros_like(h[l]))
    return gate(out)


def forward(params: Params, gb: GraphBatch, cfg: NequIPConfig
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
    h: IrrepFeat = {
        0: gather_rows(params["embed"], gb.node_feat)[:, :, None]}
    for l in range(1, cfg.l_max + 1):
        h[l] = torch.zeros((N, M, 2 * l + 1), dtype=cfg.dtype,
                           device=pos.device)
    for lp in params["layers"]:
        h = _interaction(lp, h, sh, rbf, gb, cfg)
        h = {l: x * gb.node_mask[:, None, None] for l, x in h.items()}

    inv = norm_squared(h)                                      # [N, M*(L+1)]
    e_atom = mlp(params["head"], inv, act=F.silu)[:, 0]
    e_atom = e_atom * gb.node_mask
    return pool(gb, e_atom, gb.graph_id, cfg.n_graphs)


def energy_loss(params: Params, gb: GraphBatch, cfg: NequIPConfig,
                targets: torch.Tensor) -> torch.Tensor:
    e = forward(params, gb, cfg)
    return torch.mean((e - targets) ** 2)


def forces(params: Params, gb: GraphBatch, cfg: NequIPConfig
           ) -> torch.Tensor:
    """F = -dE/dpositions (equivariant), by autograd on a copy of the
    positions that requires grad."""
    pos = gb.positions.detach().requires_grad_()
    with torch.enable_grad():
        e = torch.sum(forward(params, dataclasses.replace(gb, positions=pos),
                              cfg))
        (g,) = torch.autograd.grad(e, pos)
    return -g

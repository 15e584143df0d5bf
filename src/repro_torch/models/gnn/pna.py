"""PNA: Principal Neighbourhood Aggregation [arXiv:2004.05718].

Multi-aggregator (mean/max/min/std) × degree-scaler (identity/amplification/
attenuation) message passing over :class:`GraphBatch`.  The aggregation is
the reference's: segment sums and extrema over the edge list
(``index_add`` / ``scatter_reduce``), mask-aware.  It does not route
through the hand-written ``segment_multi_agg`` kernel, which computes the
same four aggregates over bucketed messages; the reference's PNA does not
either.

With ``cfg.mesh`` (a rank mesh) and ``shard_axes``, each layer runs
dst-partitioned as the reference's ``_layer_sharded``: the batch a rank
passes is its block (nodes split over ``shard_axes`` in equal ranges, its
edges those whose destination it owns, from
``graphops.distributed.partition_edges_by_dst``), each layer all-gathers
the node features once, and the forward pass returns this rank's rows.
``loss_fn`` and the pooled readout sum over the shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.graphops.distributed import dst_partitioned_aggregate
from repro_torch.graphops.segment import (
    segment_extremum, segment_mean, segment_sum,
)
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import require_rank_mesh
from repro_torch.models.common import (
    Params, dense, dense_init, mlp, mlp_init,
)
from repro_torch.models.gnn.graphdata import GraphBatch
from repro_torch.utils.device import DeviceLike


@dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 1433
    n_classes: int = 8
    avg_degree: float = 4.0          # delta, from the training graphs
    graph_level: bool = False        # molecule regime: pooled readout
    n_graphs: int = 1                # graphs per batch (molecule regime)
    dtype: torch.dtype = torch.float32
    # distributed aggregation over dst-partitioned edges: a rank mesh (see
    # launch/mesh.py) and the axes the nodes shard over
    mesh: object = None
    shard_axes: tuple = ()


def init_params(gen: torch.Generator, cfg: PNAConfig,
                device: DeviceLike = None) -> Params:
    h = cfg.d_hidden
    kw = {"dtype": cfg.dtype, "device": device}
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "msg": mlp_init(gen, [2 * h, h, h], **kw),
            # scaler-factored post projection: out = agg@W_id
            #   + s_amp*(agg@W_amp) + s_att*(agg@W_att), the paper's
            # [4h x 3 scalers -> h] linear without the [N, 12h] concat
            "post_id": dense_init(gen, 4 * h, h, **kw),
            "post_amp": dense_init(gen, 4 * h, h, **kw),
            "post_att": dense_init(gen, 4 * h, h, **kw),
        })
    return {
        "proj": dense_init(gen, cfg.d_in, h, **kw),
        "layers": layers,
        "head": mlp_init(gen, [h, h, cfg.n_classes], **kw),
    }


def _aggregate(msg: torch.Tensor, dst: torch.Tensor, emask: torch.Tensor,
               n: int):
    """Mask-aware 4-way aggregation: padded edges count in neither the mean
    nor the std denominators; rows with no valid edge give 0 for max, min
    and std.  Returns ([n, 4D] = mean | max | min | std, degrees [n])."""
    w = emask.to(msg.dtype)[:, None]
    m = msg * w
    deg = segment_sum(emask.to(msg.dtype), dst, n)
    safe = torch.clamp_min(deg, 1.0)[:, None]
    mean = segment_sum(m, dst, n) / safe
    meansq = segment_sum(msg * msg * w, dst, n) / safe
    # meansq - mean² with the exact product and one rounding, as the
    # reference's compiled expression (a fused multiply-add) takes it:
    # where the variance is near 0 (a node of in-degree 1), that residual
    # decides the std
    var = (meansq.double() - mean.double() * mean.double()).to(msg.dtype)
    std = torch.sqrt(torch.clamp_min(var, 0.0) + 1e-5)
    big = 3.4e38
    mx = segment_extremum(torch.where(w > 0, msg, -big), dst, n, "amax")
    mn = segment_extremum(torch.where(w > 0, msg, big), dst, n, "amin")
    has = (deg > 0)[:, None]
    mx = torch.where(has, mx, 0.0)
    mn = torch.where(has, mn, 0.0)
    std = torch.where(has, std, 0.0)
    return torch.cat([mean, mx, mn, std], dim=-1), deg


def _layer_local(lp, h_full, h_l, src_l, dst_local, emask_l, nmask_l,
                 n_loc: int, delta: float):
    """One PNA layer on one device.  h_full: [N, h] features; the rest
    local-range-sized (the whole graph on one device)."""
    src_l, dst_local = src_l.long(), dst_local.long()
    hs = h_full[src_l]
    hd = h_full[dst_local] if n_loc == h_full.shape[0] else h_l[dst_local]
    msg = mlp(lp["msg"], torch.cat([hs, hd], dim=-1), act=torch.relu)
    agg, deg = _aggregate(msg, dst_local, emask_l, n_loc)
    logd = torch.log1p(deg)[:, None]
    s_amp = logd / delta
    s_att = torch.where(logd > 0, delta / torch.clamp_min(logd, 1e-6), 0.0)
    upd = (dense(lp["post_id"], agg)
           + s_amp * dense(lp["post_amp"], agg)
           + s_att * dense(lp["post_att"], agg))
    return torch.relu(h_l + upd) * nmask_l[:, None]


def _layer_sharded(lp, h_l, gb: GraphBatch, cfg: PNAConfig, delta: float):
    """One layer on this rank's block: dst-partitioned edges, one feature
    all-gather; returns this rank's rows."""
    axes = tuple(cfg.shard_axes)
    n_loc = h_l.shape[0]

    def local(h_full, src_l, dst_local, emask_l, _n):
        dst_local = torch.clamp(dst_local, 0, n_loc - 1)
        return _layer_local(lp, h_full, h_l, src_l, dst_local, emask_l,
                            gb.node_mask, n_loc, delta)

    return dst_partitioned_aggregate(h_l, gb.edge_src, gb.edge_dst,
                                     gb.edge_mask, local, cfg.mesh, axes)


def _pool_sharded(h_l, gb: GraphBatch, cfg: PNAConfig) -> torch.Tensor:
    """The per-graph mean over every rank's nodes (``segment_mean`` of the
    whole batch): sums and counts summed over the shards."""
    axes = tuple(cfg.shard_axes)
    sums = segment_sum(h_l * gb.node_mask[:, None], gb.graph_id,
                       cfg.n_graphs)
    cnt = segment_sum(h_l.new_ones(h_l.shape[:1]), gb.graph_id, cfg.n_graphs)
    sums, cnt = C.psum(sums, axes, cfg.mesh), C.psum(cnt, axes, cfg.mesh)
    return sums / torch.clamp_min(cnt, 1e-9)[:, None]


def forward(params: Params, gb: GraphBatch, cfg: PNAConfig) -> torch.Tensor:
    """Logits of every node (graph-level: of every graph); with a mesh, of
    this rank's nodes (graph-level: every graph's, on every rank)."""
    sharded = cfg.mesh is not None
    if sharded:
        require_rank_mesh(cfg.mesh, "PNAConfig.mesh")
    n = gb.n_nodes
    x = gb.node_feat.to(cfg.dtype)
    h = torch.relu(dense(params["proj"], x))
    delta = max(math.log(cfg.avg_degree + 1.0), 1e-3)
    for lp in params["layers"]:
        if sharded:
            h = _layer_sharded(lp, h, gb, cfg, delta)
            continue
        h = _layer_local(lp, h, h, gb.edge_src, gb.edge_dst, gb.edge_mask,
                         gb.node_mask, n, delta)
    if cfg.graph_level:
        pooled = (_pool_sharded(h, gb, cfg) if sharded else segment_mean(
            h * gb.node_mask[:, None], gb.graph_id, cfg.n_graphs))
        return mlp(params["head"], pooled, act=torch.relu)
    return mlp(params["head"], h, act=torch.relu)


def loss_fn(params: Params, gb: GraphBatch, cfg: PNAConfig) -> torch.Tensor:
    """Masked mean node NLL; with a mesh, over every rank's nodes (the same
    value on every rank)."""
    logits = forward(params, gb, cfg).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, gb.labels.long()[:, None])[:, 0]
    mask = gb.node_mask.to(torch.float32)
    total, count = torch.sum((logz - gold) * mask), mask.sum()
    if cfg.mesh is not None:
        axes = tuple(cfg.shard_axes)
        total = C.psum(total, axes, cfg.mesh)
        count = C.psum(count, axes, cfg.mesh)
    return total / torch.clamp_min(count, 1.0)

"""GraphSAGE-style convolution over :class:`GraphBatch`, with the neighbor
aggregation optionally routed through the hand-written ``block_spmm``
kernel (DESIGN.md §14).

Mean aggregation is ``agg = Adj @ H / deg`` with ``Adj[dst, src] = w``.
With ``use_block_spmm`` the adjacency is built dense and the product runs
through :func:`repro_torch.kernels.ops.block_spmm` on its fp32 route (both
operands float32); the segment path (gather, scale, ``index_add``) is the
parity twin and the path that trains.  The kernel has no backward, as the
reference's Pallas kernel has none: ``use_block_spmm`` is for inference.
Parameters are a dictionary in the reference's names and layouts
(``enc``, ``self{i}``, ``nbr{i}``, ``head``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import Params, dense, dense_init
from repro_torch.models.gnn.graphdata import GraphBatch
from repro_torch.utils.device import DeviceLike


@dataclass(frozen=True)
class SAGEConfig:
    d_in: int = 11                # structural_features FEAT_DIM
    d_hidden: int = 128
    n_classes: int = 8
    n_layers: int = 2
    use_block_spmm: bool = False  # route aggregation through block_spmm


def init_params(gen: torch.Generator, cfg: SAGEConfig,
                device: DeviceLike = None) -> Params:
    def lin(d_in, d_out, bias):
        return dense_init(gen, d_in, d_out, bias=bias, device=device)

    p: Params = {"enc": lin(cfg.d_in, cfg.d_hidden, True)}
    for i in range(cfg.n_layers):
        p[f"self{i}"] = lin(cfg.d_hidden, cfg.d_hidden, True)
        p[f"nbr{i}"] = lin(cfg.d_hidden, cfg.d_hidden, False)
    p["head"] = lin(cfg.d_hidden, cfg.n_classes, True)
    return p


def _edge_weights(batch: GraphBatch) -> torch.Tensor:
    """Per-edge message weights: the path counts (1 without them), 0 on
    padding edges."""
    mask = batch.edge_mask.to(torch.float32)
    return mask if batch.edge_weight is None else batch.edge_weight * mask


def dense_adjacency(batch: GraphBatch) -> torch.Tensor:
    """``adj[dst, src] += w`` as a dense fp32 ``[N, N]`` tensor: the
    ``block_spmm`` operand of the aggregation."""
    n = batch.n_nodes
    adj = torch.zeros((n, n), dtype=torch.float32,
                      device=batch.node_feat.device)
    return adj.index_put_((batch.edge_dst.long(), batch.edge_src.long()),
                          _edge_weights(batch), accumulate=True)


def _aggregate(cfg: SAGEConfig, batch: GraphBatch, h: torch.Tensor
               ) -> torch.Tensor:
    """Mean of incoming neighbor messages: agg[i] = Σ_j w_ij h[j] / deg_i."""
    if cfg.use_block_spmm:
        adj = dense_adjacency(batch)
        tot = ops.block_spmm(adj, h.to(torch.float32).contiguous(),
                             counting=True, out_dtype=torch.float32)
        deg = adj.sum(1, keepdim=True)
    else:
        w = _edge_weights(batch)
        dst = batch.edge_dst.long()
        msg = h[batch.edge_src.long()] * w[:, None]
        tot = h.new_zeros(h.shape).index_add(0, dst, msg)
        deg = w.new_zeros(h.shape[0]).index_add(0, dst, w)[:, None]
    return tot / torch.clamp_min(deg, 1.0)


def embed(params: Params, cfg: SAGEConfig, batch: GraphBatch
          ) -> torch.Tensor:
    """Node embeddings [N, d_hidden] (pre-classifier)."""
    mask = batch.node_mask[:, None].to(torch.float32)
    h = torch.relu(dense(params["enc"], batch.node_feat)) * mask
    for i in range(cfg.n_layers):
        agg = _aggregate(cfg, batch, h)
        h = torch.relu(dense(params[f"self{i}"], h)
                       + dense(params[f"nbr{i}"], agg)) * mask
    return h


def forward(params: Params, cfg: SAGEConfig, batch: GraphBatch
            ) -> torch.Tensor:
    """Per-node class logits [N, n_classes]."""
    return dense(params["head"], embed(params, cfg, batch))


def loss_fn(params: Params, cfg: SAGEConfig, batch: GraphBatch
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked cross-entropy on node labels; returns (loss, accuracy)."""
    logits = forward(params, cfg, batch)
    labels = (batch.labels % cfg.n_classes).long()
    logp = torch.log_softmax(logits, dim=-1)
    mask = batch.node_mask.to(torch.float32)
    denom = torch.clamp_min(mask.sum(), 1.0)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    loss = (nll * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels).to(torch.float32) * mask).sum() / denom
    return loss, acc

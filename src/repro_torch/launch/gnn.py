"""View-fed GNN training/inference loops (DESIGN.md §14).

A materialized view is the training substrate: :func:`train_on_view` runs
mini-batch SAGE epochs where every epoch (1) refreshes the view's
:class:`~repro_torch.graphops.view_subgraph.ViewSubgraph` under the view's
own freshness policy — incremental, label-epoch-keyed, no re-extraction —
and (2) samples fanout minibatches off the maintained CSR.  Each step is
autograd over the SAGE loss and a plain SGD update, ``p - lr * g``.

:class:`ViewEmbedder` adapts a trained model into the serve engine's
embedding-read protocol (``serve/engine.py``): ``refresh()`` re-embeds the
subgraph only when the view's structure version moved, ``lookup()`` answers
node-id reads from the cached table.  Inference may route SAGE's
aggregation through ``block_spmm`` (``use_block_spmm``); training may not,
since the kernel has no backward.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.graphops.sampler import max_subgraph_size
from repro_torch.graphops.view_subgraph import FEAT_DIM, ViewSubgraph
from repro_torch.models.common import Params
from repro_torch.models.gnn import sage
from repro_torch.utils import host, round_up


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 3
    batch_nodes: int = 64            # seeds per minibatch
    fanout: Tuple[int, ...] = (5, 5)
    lr: float = 1e-2
    d_hidden: int = 128
    n_classes: int = 8
    n_layers: int = 2
    seed: int = 0
    use_block_spmm: bool = False     # block_spmm aggregation (inference only)
    drain: Optional[bool] = None     # None = view's freshness policy


@dataclass
class TrainReport:
    """Typed result of :func:`train_on_view` (no tuple unpacking)."""

    view: str
    epochs: int = 0
    steps: int = 0
    losses: List[float] = field(default_factory=list)
    final_acc: float = 0.0
    refreshes: int = 0               # subgraph CSR rebuilds during training


def _pads(sub: ViewSubgraph, cfg: TrainConfig) -> Tuple[int, int]:
    n, e = max_subgraph_size(cfg.batch_nodes, cfg.fanout)
    return round_up(n, 128), round_up(max(e, 1), 128)


def _model_cfg(cfg: TrainConfig) -> sage.SAGEConfig:
    return sage.SAGEConfig(
        d_in=FEAT_DIM, d_hidden=cfg.d_hidden, n_classes=cfg.n_classes,
        n_layers=cfg.n_layers, use_block_spmm=cfg.use_block_spmm)


def _train_step(mcfg: sage.SAGEConfig):
    """``step(params, batch, lr) -> (params, loss, acc)``: one SGD step on
    the SAGE loss.  Training runs on the segment path only: ``block_spmm``
    has no backward (the reference's Pallas kernel has none either)."""
    if mcfg.use_block_spmm:
        raise ValueError(
            "use_block_spmm cannot train: the block_spmm kernel has no "
            "backward; train on the segment path and embed with it")

    def step(params: Params, batch, lr: float):
        leaves = [(k, kk, v.detach().requires_grad_())
                  for k, layer in params.items() for kk, v in layer.items()]
        live: Params = {}
        for k, kk, v in leaves:
            live.setdefault(k, {})[kk] = v
        loss, acc = sage.loss_fn(live, mcfg, batch)
        grads = torch.autograd.grad(loss, [v for _, _, v in leaves])
        new: Params = {}
        with torch.no_grad():
            for (k, kk, v), g in zip(leaves, grads):
                new.setdefault(k, {})[kk] = v - lr * g
        return new, loss.detach(), acc.detach()
    return step


def epoch_batches(sub: ViewSubgraph, cfg: TrainConfig, epoch: int):
    """Deterministic minibatch stream for one epoch: shuffled seed chunks,
    each sampled and padded to the static (node_pad, edge_pad) shape."""
    seeds = sub.seed_nodes()
    if seeds.size == 0:
        return
    rng = np.random.default_rng(cfg.seed + 7919 * epoch)
    order = rng.permutation(seeds)
    node_pad, edge_pad = _pads(sub, cfg)
    smp = sub.sampler()
    for i, lo in enumerate(range(0, order.shape[0], cfg.batch_nodes)):
        chunk = np.sort(order[lo: lo + cfg.batch_nodes])
        sg = smp.sample(chunk, cfg.fanout, seed=cfg.seed + 31 * epoch + i)
        yield sub.batch_from_sample(sg, node_pad=node_pad, edge_pad=edge_pad)


def train_on_view(session, view, cfg: TrainConfig = TrainConfig()
                  ) -> Tuple[Params, TrainReport]:
    """Mini-batch SAGE training with the view as the (maintained) dataset.

    ``view`` is a name or a ViewHandle.  Each epoch starts with an
    incremental ``ViewSubgraph.refresh`` — mid-training ``apply_writes``
    to the base graph flow into the next epoch's sampling CSR through the
    view's §5 maintenance deltas, at the drain points the view's freshness
    policy dictates.  Parameters start from
    ``torch.Generator().manual_seed(cfg.seed)`` and live on the session's
    device.
    """
    name = view if isinstance(view, str) else view.name
    sub = session.view(name).subgraph()
    mcfg = _model_cfg(cfg)
    step = _train_step(mcfg)
    params = sage.init_params(torch.Generator().manual_seed(cfg.seed), mcfg,
                              device=session.device)
    rpt = TrainReport(view=name)
    rebuilds0 = sub.csr_rebuilds
    acc = 0.0
    for epoch in range(cfg.epochs):
        sub.refresh(drain=cfg.drain)
        ep_loss, nb = 0.0, 0
        for batch in epoch_batches(sub, cfg, epoch):
            params, loss, acc = step(params, batch, cfg.lr)
            ep_loss += float(loss)
            nb += 1
            rpt.steps += 1
        rpt.losses.append(ep_loss / max(nb, 1))
        rpt.epochs += 1
    rpt.final_acc = float(acc)
    rpt.refreshes = sub.csr_rebuilds - rebuilds0
    return params, rpt


def _embed_table(sub: ViewSubgraph, params: Params,
                 mcfg: sage.SAGEConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Embeddings of every node of the maintained subgraph, in sorted id
    order, and those ids."""
    batch = sub.to_graphbatch()
    with torch.no_grad():
        h = host(sage.embed(params, mcfg, batch))
    ids = sub.nodes()
    return h[: ids.shape[0]], ids


def embed_on_view(session, view, params: Params,
                  cfg: TrainConfig = TrainConfig(),
                  node_ids: Optional[Sequence[int]] = None) -> np.ndarray:
    """Full-subgraph inference: [n, d_hidden] embeddings for ``node_ids``
    (default: every node of the maintained subgraph, in sorted id order)."""
    name = view if isinstance(view, str) else view.name
    sub = session.view(name).subgraph()
    sub.refresh(drain=cfg.drain)
    h, ids = _embed_table(sub, params, _model_cfg(cfg))
    if node_ids is None:
        return h
    loc = np.full(sub.num_nodes, -1, np.int64)
    loc[ids] = np.arange(ids.shape[0])
    pos = loc[np.asarray(node_ids, np.int64)]
    out = np.zeros((pos.shape[0], h.shape[1]), h.dtype)
    hit = pos >= 0
    out[hit] = h[pos[hit]]
    return out


class ViewEmbedder:
    """Serve-protocol adapter: version-cached embeddings over a view.

    Duck-typed against ``ServeEngine.register_embedder`` — the engine never
    imports this module.  ``refresh()`` recomputes the embedding table only
    when the subgraph's structure version moved (a drained write to the
    view); ``lookup()`` is a host gather.
    """

    def __init__(self, session, view, params: Params,
                 cfg: TrainConfig = TrainConfig()):
        self.view_name = view if isinstance(view, str) else view.name
        self._sess = session
        self._params = params
        self._cfg = cfg
        self._mcfg = _model_cfg(cfg)
        self._table: Optional[np.ndarray] = None
        self._loc: Optional[np.ndarray] = None
        self.version = -1
        self.dim = cfg.d_hidden

    @property
    def subgraph(self) -> ViewSubgraph:
        return self._sess.view(self.view_name).subgraph()

    def refresh(self) -> bool:
        """Sync the table with the maintained subgraph; True if re-embedded."""
        sub = self.subgraph
        sub.refresh(drain=self._cfg.drain)
        if self._table is not None and sub.version == self.version:
            return False
        self._table, ids = _embed_table(sub, self._params, self._mcfg)
        self._loc = np.full(sub.num_nodes, -1, np.int64)
        self._loc[ids] = np.arange(ids.shape[0])
        self.version = sub.version
        return True

    def lookup(self, node_ids: Sequence[int]) -> np.ndarray:
        """[n, dim] embeddings; zero rows for ids outside the subgraph."""
        if self._table is None:
            self.refresh()
        pos = self._loc[np.asarray(node_ids, np.int64)]
        out = np.zeros((pos.shape[0], self.dim), self._table.dtype)
        hit = pos >= 0
        out[hit] = self._table[pos[hit]]
        return out

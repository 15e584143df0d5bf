"""MIND: multi-interest network with dynamic (capsule) routing
[arXiv:1904.08030], the port of ``repro.models.recsys.mind``.

User behavior sequence -> K interest capsules via B2I dynamic routing
(3 iterations, squash); training uses label-aware attention + sampled
softmax (in-batch negatives); serving scores a candidate by max over
interests.

The routing logits start from a fixed draw, the reference's
``jax.random.normal(PRNGKey(7), (1, L, K))``: the port takes it from its
own numpy copy of JAX's generator (``utils.jax_random``), so both packages
route from the same logits.

``logits_pspec = (data_axes, None)`` shards the [B, B] in-batch logits by
rows over the rank mesh passed to ``train_loss`` (the reference takes the
ambient mesh): ``train_loss`` takes this rank's [B/dp] block of the batch,
computes its rows against the all-gathered target embeddings, with the
gold labels moved by its first row, and returns the mean over every row
(the ``pmean`` of the ranks' means), equal to the single-device loss.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.graphops.distributed import flat_axis_index
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import require_rank_mesh
from repro_torch.models.common import (
    Params, dense, dense_init, mlp, mlp_init,
)
from repro_torch.models.recsys.embedding import (
    embedding_lookup, embedding_table_init,
)
from repro_torch.utils import jax_random
from repro_torch.utils.device import DeviceLike

ROUTING_SEED = 7


@dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    dtype: Any = torch.float32
    # row sharding of the [B, B] in-batch logits, (data axes, None), over
    # the rank mesh given to train_loss; without it one device holds B x B
    logits_pspec: object = None


def _row_axes(cfg: MINDConfig, mesh) -> Tuple[str, ...]:
    """The axes the logits' rows shard over (checks the spec and mesh)."""
    require_rank_mesh(mesh, "MINDConfig.logits_pspec")
    rows, cols = cfg.logits_pspec
    if cols is not None or rows is None:
        raise ValueError(f"logits_pspec {cfg.logits_pspec}: the port shards "
                         f"the in-batch logits by rows only, (axes, None)")
    return (rows,) if isinstance(rows, str) else tuple(rows)


def init_params(gen: torch.Generator, cfg: MINDConfig,
                device: DeviceLike = None) -> Params:
    kw = {"dtype": cfg.dtype, "device": device}
    return {
        "items": embedding_table_init(gen, cfg.n_items, cfg.embed_dim, **kw),
        # shared bilinear map S for B2I routing
        "s_map": dense_init(gen, cfg.embed_dim, cfg.embed_dim, **kw),
        "out_mlp": mlp_init(gen, [cfg.embed_dim, 2 * cfg.embed_dim,
                                  cfg.embed_dim], **kw),
    }


def _squash(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n2 = torch.sum(v * v, dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * v / torch.sqrt(n2 + 1e-9)


@lru_cache(maxsize=16)
def routing_logits(L: int, K: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """The fixed initial routing logits [1, L, K]: JAX's
    ``normal(PRNGKey(7), (1, L, K))`` in float32, cast to ``dtype``; one
    tensor per (L, K, dtype, device), shared by every call (read only)."""
    b0 = jax_random.normal(ROUTING_SEED, (1, L, K))
    return torch.from_numpy(b0.copy()).to(device=device, dtype=dtype)


def interests(params: Params, hist: torch.Tensor, hist_mask: torch.Tensor,
              cfg: MINDConfig) -> torch.Tensor:
    """Behavior-to-interest dynamic routing.  hist: [B, L] -> [B, K, D]."""
    B, L = hist.shape
    K = cfg.n_interests
    e = embedding_lookup(params["items"], hist)            # [B, L, D]
    e = e * hist_mask[..., None].to(e.dtype)
    eh = dense(params["s_map"], e)                         # [B, L, D]

    # routing logits b: fixed random init (paper: randomly initialized, not
    # learned); deterministic per position for reproducibility
    b = routing_logits(L, K, eh.dtype, eh.device).expand(B, L, K)
    mask_bias = torch.where(hist_mask[..., None], 0.0, -1e30)
    caps = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b + mask_bias, dim=-1)           # [B, L, K]
        caps = torch.einsum("blk,bld->bkd", w, eh)
        caps = _squash(caps)
        b = b + torch.einsum("bkd,bld->blk", caps, eh)
    return mlp(params["out_mlp"], caps, act=F.relu)        # [B, K, D]


def label_aware_attention(caps: torch.Tensor, target_emb: torch.Tensor,
                          p: float = 2.0) -> torch.Tensor:
    """Weight interests by similarity^p to the target item.  [B,K,D],[B,D]."""
    sim = torch.einsum("bkd,bd->bk", caps, target_emb)
    w = torch.softmax(p * sim, dim=-1)
    return torch.einsum("bk,bkd->bd", w, caps)


def train_loss(params: Params, batch: Dict[str, torch.Tensor],
               cfg: MINDConfig, mesh=None) -> torch.Tensor:
    """Sampled-softmax with in-batch negatives; with ``logits_pspec``, this
    rank's rows of the batch on the rank mesh ``mesh`` (the loss is every
    row's mean)."""
    caps = interests(params, batch["hist"], batch["hist_mask"], cfg)
    tgt = embedding_lookup(params["items"], batch["target"])   # [B, D]
    user = label_aware_attention(caps, tgt)                    # [B, D]
    first = 0
    if cfg.logits_pspec is not None:
        axes = _row_axes(cfg, mesh)
        first = flat_axis_index(axes, mesh) * tgt.shape[0]
        tgt = C.all_gather(tgt, axes, mesh, axis=0)            # [B, D]
    logits = (user @ tgt.T).to(torch.float32)                  # [B(/dp), B]
    labels = first + torch.arange(logits.shape[0], device=logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    if cfg.logits_pspec is not None:
        loss = C.pmean(loss, axes, mesh)
    return loss


def score_candidates(params: Params, hist: torch.Tensor,
                     hist_mask: torch.Tensor, cand: torch.Tensor,
                     cfg: MINDConfig) -> torch.Tensor:
    """Serving: max-over-interests dot scores.  cand: [B, C] -> [B, C]."""
    caps = interests(params, hist, hist_mask, cfg)             # [B, K, D]
    ce = embedding_lookup(params["items"], cand)               # [B, C, D]
    scores = torch.einsum("bkd,bcd->bkc", caps, ce)
    return torch.amax(scores, dim=1)


def retrieval_scores(params: Params, hist: torch.Tensor,
                     hist_mask: torch.Tensor, cfg: MINDConfig,
                     cand_ids: torch.Tensor) -> torch.Tensor:
    """Bulk retrieval: one user against n_candidates (batched dot, no loop).

    hist: [1, L]; cand_ids: [C] -> [C] scores."""
    caps = interests(params, hist, hist_mask, cfg)[0]          # [K, D]
    ce = embedding_lookup(params["items"], cand_ids)           # [C, D]
    return torch.amax(ce @ caps.T, dim=-1)

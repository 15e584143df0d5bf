"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its kernel computes with ordinary tensor
operations.  The CPU path and the tests use them; on the card they are the
kernels' oracles and nothing on the main path calls them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 product with TF32 explicitly off: integer-valued operands give
    exact integer sums below 2^24, which TF32's 10-bit mantissa would not."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a.to(torch.float32) @ b.to(torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def block_spmm_ref(F: torch.Tensor, A: torch.Tensor,
                   col_mask: Optional[torch.Tensor] = None,
                   semiring: str = "count") -> torch.Tensor:
    """Frontier-hop semantics of the ``block_spmm`` kernel, in fp32.

    counting: ``out = (F @ A) * mask``;  boolean: ``out = min(F @ A, 1) * mask``.
    Walk counts are exact up to 2^24.
    """
    out = matmul_f32(F, A)
    if semiring == "bool":
        out = torch.clamp_max(out, 1.0)
    if col_mask is not None:
        out = out * col_mask.to(torch.float32)[None, :]
    return out


def spmm_slab_map_ref(A: torch.Tensor, bk: int = 64, bn: int = 128
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The slab map of ``block_spmm``'s u8 route, as its two kernels write it.

    A tile is one ``bk``-row slab of A [K, N] by one column block of ``bn``
    columns; it is live if it holds a non-zero.  Returns (slabs int16
    [n_colblocks, n_slabs]: each column block's live slabs in ascending
    order, then -1; counts int32 [n_colblocks]).
    """
    K, N = A.shape
    n_slabs, n_cb = -(-K // bk), -(-N // bn)
    nz = torch.zeros((n_slabs * bk, n_cb * bn), dtype=torch.bool,
                     device=A.device)
    nz[:K, :N] = A != 0
    live = nz.view(n_slabs, bk, n_cb, bn).any(3).any(1).T
    order = torch.arange(n_slabs, device=A.device).expand(n_cb, n_slabs)
    first = torch.where(live, order, order + n_slabs).sort(dim=1).values
    slabs = torch.where(first < n_slabs, first, -1).to(torch.int16)
    return slabs, live.sum(1).to(torch.int32)


def spmm_slab_walk_ref(F: torch.Tensor, A: torch.Tensor, slabs: torch.Tensor,
                       counts: torch.Tensor, bk: int = 64,
                       bn: int = 128) -> torch.Tensor:
    """``F @ A`` summed over the listed tiles alone, as the u8 route walks
    them: each column block adds ``F[:, slab] @ A[slab, block]`` for its
    first ``counts`` slabs.  Exact int64 sums [S, N]."""
    S, N = F.shape[0], A.shape[1]
    out = torch.zeros((S, N), dtype=torch.int64, device=F.device)
    for cb in range(slabs.shape[0]):
        cols = slice(cb * bn, min((cb + 1) * bn, N))
        for ks in slabs[cb, :int(counts[cb])].tolist():
            rows = slice(ks * bk, (ks + 1) * bk)
            out[:, cols] += F[:, rows].long() @ A[rows, cols].long()
    return out


def segment_multi_agg_ref(msg: torch.Tensor, valid: torch.Tensor,
                          eps: float = 1e-5) -> Tuple[torch.Tensor, ...]:
    """PNA multi-aggregator over bucketed neighbours, in ``msg.dtype``.

    msg: [N, W, D] bucketed neighbour messages (padded), valid: [N, W]
    slot validity.  Returns (mean, max, min, std), each [N, D], with
    ``std = sqrt(max(E[x²] - mean², 0) + eps)``; empty rows give zeros.
    """
    v = valid[:, :, None].to(msg.dtype)
    cnt = valid.to(msg.dtype).sum(dim=1)[:, None]
    safe = torch.clamp_min(cnt, 1.0)
    mean = (msg * v).sum(dim=1) / safe
    mx = torch.where(v > 0, msg, -3.4e38).amax(dim=1)
    mn = torch.where(v > 0, msg, 3.4e38).amin(dim=1)
    nonempty = cnt > 0
    mx = torch.where(nonempty, mx, 0.0)
    mn = torch.where(nonempty, mn, 0.0)
    meansq = (msg * msg * v).sum(dim=1) / safe
    # meansq - mean² with the exact product and one rounding, as the
    # reference's compiled expression (a fused multiply-add) and the kernel
    # take it: where the variance is near 0, that residual decides the std
    var = (meansq.double() - mean.double() * mean.double()).to(msg.dtype)
    std = torch.sqrt(torch.clamp_min(var, 0.0) + eps)
    std = torch.where(nonempty, std, 0.0)
    return mean, mx, mn, std


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """Decode-friendly causal mask: query i attends keys <= i + (sk - sq)."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    return kj <= qi + (sk - sq)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, scale: Optional[float] = None
            ) -> torch.Tensor:
    """Attention oracle.  q: [B,H,Sq,D], k/v: [B,H,Sk,D] -> [B,H,Sq,D].

    Like the reference oracle it casts the probabilities to ``v.dtype``
    before the product with v; ``flash_attention_ref`` does not."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    if causal:
        mask = _causal_mask(q.shape[-2], k.shape[-2], q.device)
        logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Single-token decode oracle.  q: [B,H,D], k/v: [B,H,S,D].

    ``kv_len`` masks the valid prefix of the cache (per batch)."""
    d = q.shape[-1]
    logits = torch.einsum("bhd,bhsd->bhs", q, k).to(torch.float32) / (d ** 0.5)
    if kv_len is not None:
        s = k.shape[-2]
        mask = (torch.arange(s, device=q.device)[None, None, :]
                < kv_len[:, None, None])
        logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p.to(v.dtype), v)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """What the ``flash_attention`` kernel computes, without tiling.

    q: [B,Hq,Sq,D], k/v: [B,Hkv,Sk,D] with Hq a multiple of Hkv (query head
    h reads KV head h // (Hq/Hkv)) and Sk >= Sq.  Scores, softmax and the
    product with v run in fp32 (TF32 off), scale 1/sqrt(D), the causal
    diagonal shifted by Sk - Sq; the output is cast to ``q.dtype``.
    """
    hq, hkv, d = q.shape[1], k.shape[1], q.shape[-1]
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    if hkv != hq:
        kf = kf.repeat_interleave(hq // hkv, dim=1)
        vf = vf.repeat_interleave(hq // hkv, dim=1)
    logits = matmul_f32(qf, kf.transpose(-1, -2)) * (1.0 / d ** 0.5)
    if causal:
        mask = _causal_mask(q.shape[-2], k.shape[-2], q.device)
        logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return matmul_f32(p, vf).to(q.dtype)


def merge_attention_partials(acc: torch.Tensor, m: torch.Tensor,
                             l: torch.Tensor,
                             out_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Combine split-KV partials by log-sum-exp, as the kernel's merge does.

    acc: [n, ..., D] each chunk's unnormalised fp32 sum of p·v; m, l:
    [n, ...] its rows' running max and sum of p (m = -1e30 and l = 0 where
    a chunk saw no key of a row).  Returns ``Σ w·acc / Σ w·l`` with
    ``w = exp(m - max m)`` over the chunks, a zero denominator dividing by
    1, in ``out_dtype``.
    """
    w = torch.exp(m - m.amax(dim=0, keepdim=True))
    den = (w * l).sum(dim=0)
    den = torch.where(den == 0, 1.0, den)
    return ((w[..., None] * acc).sum(dim=0) / den[..., None]).to(out_dtype)

"""Attention building blocks, the port of ``repro.models.attention``.

* ``chunked_attention`` — online softmax over KV chunks: differentiable,
  O(S·chunk) live logits (the prefill and training path), with each chunk
  recomputed in the backward pass when gradients are on.
* ``gqa_einsum_attention`` — GQA without materializing repeated KV heads
  (q reshaped to [B, Hkv, rep, S, D]).
* ``decode_attention`` — one new token against a padded cache with a
  per-row length.
* ``decode_attention_partial`` / ``combine_partials`` — split-KV
  (flash-decoding) partials (num, denom, max) over one sequence shard of
  the cache, and their log-sum-exp combine over a mesh axis.
* ``context_parallel_attention`` — one model-axis peer's S/mp queries
  against the all-gathered keys and values.

The dtypes are the reference's: products in the inputs' dtype, logits cast
to fp32, probabilities cast to ``v``'s dtype before the PV product.  None
of these routes through the hand-written ``flash_attention`` kernel (the
reference's modules do not call theirs).  The mesh functions take this
rank's blocks and a rank mesh (``launch/mesh.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import Mesh

NEG_INF = -1e30


def _gqa_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B,Hq,Sq,D], k: [B,Hkv,Sk,D] -> [B,Hq,Sq,Sk] without KV repeat."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D)
    logits = torch.einsum("bgrqd,bgkd->bgrqk", qg, k)
    return logits.reshape(B, Hq, Sq, k.shape[2])


def _gqa_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: [B,Hq,Sq,Sk], v: [B,Hkv,Sk,D] -> [B,Hq,Sq,D]."""
    B, Hq, Sq, Sk = p.shape
    Hkv = v.shape[1]
    pg = p.reshape(B, Hkv, Hq // Hkv, Sq, Sk)
    out = torch.einsum("bgrqk,bgkd->bgrqd", pg, v)
    return out.reshape(B, Hq, Sq, v.shape[3])


def _causal_keep(sq: int, sk: int, offset: int, k0: int, device
                 ) -> torch.Tensor:
    """[sq, sk] bool: query i (at global position i + offset) sees key j
    (at global position j + k0) when j + k0 <= i + offset."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(sk, device=device)[None, :] + k0
    return kj <= qi


def gqa_einsum_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Reference GQA attention (dense logits; small-S paths and oracles)."""
    D = q.shape[-1]
    logits = _gqa_logits(q, k).to(torch.float32) / (D ** 0.5)
    if causal:
        sq, sk = q.shape[-2], k.shape[-2]
        keep = _causal_keep(sq, sk, sk - sq, 0, q.device)
        logits = torch.where(keep, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return _gqa_values(p, v)


def _chunk_step(q, kb, vb, m_prev, l_prev, acc_prev, k0: int, causal: bool,
                offset: int, scale: float):
    logits = _gqa_logits(q, kb).to(torch.float32) * scale   # [B,Hq,Sq,c]
    if causal:
        keep = _causal_keep(q.shape[2], kb.shape[2], offset, k0, q.device)
        logits = torch.where(keep, logits, NEG_INF)
    m_cur = torch.maximum(m_prev, torch.amax(logits, dim=-1))
    alpha = torch.exp(m_prev - m_cur)
    p = torch.exp(logits - m_cur[..., None])
    l_cur = l_prev * alpha + torch.sum(p, dim=-1)
    acc = acc_prev * alpha[..., None] + _gqa_values(
        p.to(vb.dtype), vb).to(torch.float32)
    return m_cur, l_cur, acc


def chunked_attention(q, k, v, *, causal: bool = True, chunk: int = 512,
                      q_offset: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q: [B,Hq,Sq,D], k/v: [B,Hkv,Sk,D]; Sk % chunk == 0.
    ``q_offset``: global position of q row 0 (defaults to Sk - Sq, the
    decode alignment).  With gradients on, each chunk is checkpointed: the
    backward pass recomputes its probability tile instead of keeping
    [B,H,Sq,chunk] residuals for every chunk."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    assert Sk % chunk == 0, (Sk, chunk)
    scale = 1.0 / (D ** 0.5)
    offset = (Sk - Sq) if q_offset is None else q_offset
    grads = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))

    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, Sq, D), dtype=torch.float32, device=q.device)
    for i in range(Sk // chunk):
        kb = k[:, :, i * chunk:(i + 1) * chunk]
        vb = v[:, :, i * chunk:(i + 1) * chunk]
        args = (q, kb, vb, m, l, acc, i * chunk, causal, offset, scale)
        if grads:
            m, l, acc = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            m, l, acc = _chunk_step(*args)
    safe = torch.where(l == 0.0, 1.0, l)
    return (acc / safe[..., None]).to(q.dtype)


def context_parallel_attention(ql, kl, vl, mesh: Mesh, *,
                               model_axis: str = "model",
                               causal: bool = True,
                               chunk: int = 512) -> torch.Tensor:
    """Context-parallel attention: this model-axis peer's blocks of q, k
    and v, [B_l, H, S/mp, D] each (the sequence sharded over
    ``model_axis``), to its block of the output.

    When head counts do not divide the model axis (yi-34b: 56 q / 8 kv
    heads), each peer takes an S/mp query slice, all-gathers K/V once
    ([B, Hkv, S, D]) and runs the chunked online softmax with its global
    row offset.  The backward pass reduce-scatters the K/V gradients."""
    mp = mesh.shape[model_axis]
    S_loc = ql.shape[2]
    S = S_loc * mp
    kf = C.all_gather(kl, model_axis, mesh, axis=2)
    vf = C.all_gather(vl, model_axis, mesh, axis=2)
    return chunked_attention(ql, kf, vf, causal=causal, chunk=min(chunk, S),
                             q_offset=C.axis_index(model_axis, mesh) * S_loc)


# ------------------------------------------------------------- decode paths

def decode_attention(q, k_cache, v_cache, kv_len) -> torch.Tensor:
    """One-token decode.  q: [B,Hq,D]; caches: [B,Hkv,S,D]; kv_len: [B]."""
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bgrd,bgsd->bgrs", qg, k_cache).to(torch.float32)
    logits = logits / (D ** 0.5)
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            < kv_len[:, None, None, None])
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bgrs,bgsd->bgrd", p, v_cache)
    return out.reshape(B, Hq, D)


def decode_attention_partial(q, k_shard, v_shard, valid_mask
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Split-KV partial attention over one sequence shard of the cache.

    q: [B,Hq,D]; k/v_shard: [B,Hkv,Ss,D]; valid_mask: [B,Ss] bool.
    Returns (num [B,Hq,D], denom [B,Hq], max [B,Hq]): exact flash-decoding
    partials, to be merged across shards by a log-sum-exp combine.
    """
    B, Hq, D = q.shape
    Hkv = k_shard.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bgrd,bgsd->bgrs", qg, k_shard).to(torch.float32)
    logits = logits / (D ** 0.5)
    logits = torch.where(valid_mask[:, None, None, :], logits, NEG_INF)
    m = torch.amax(logits, dim=-1)                       # [B,Hkv,rep]
    p = torch.exp(logits - m[..., None])
    denom = torch.sum(p, dim=-1)
    num = torch.einsum("bgrs,bgsd->bgrd", p.to(v_shard.dtype), v_shard
                       ).to(torch.float32)
    return (num.reshape(B, Hq, D), denom.reshape(B, Hq), m.reshape(B, Hq))


def combine_partials(num, denom, m, axis_name: str, mesh: Mesh
                     ) -> torch.Tensor:
    """Log-sum-exp combine of split-KV partials across a mesh axis: every
    peer's [B, Hq, D] output."""
    m_glob = C.pmax(m, axis_name, mesh)
    scale = torch.exp(m - m_glob)
    num_g = C.psum(num * scale[..., None], axis_name, mesh)
    den_g = C.psum(denom * scale, axis_name, mesh)
    safe = torch.where(den_g == 0.0, 1.0, den_g)
    return num_g / safe[..., None]

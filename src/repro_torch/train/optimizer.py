"""AdamW from scratch, with an 8-bit-state variant: the port of
``repro.train.optimizer``.

The arithmetic is the reference's, element by element.  Two things differ
for memory, and change no result:

* fp32 moments are updated in place (the state passed in is the state
  returned), and 8-bit moments are requantized into their own ``q`` and
  ``s`` tensors;
* every leaf is walked in slices along its leading axis of at most
  :data:`SLICE_ELEMS` elements (one layer of a stacked ``[L, ...]`` leaf
  where a layer is larger), so the fp32 temporaries of an update stay a
  slice's size: a starcoder2-3b FFN leaf, ``[30, 3072, 12288]``, would
  otherwise add about 22.6 GB of them.

The 8-bit variant stores moments as int8 with per-block absmax scales
(blocks of up to 256 along the last dim), the second moment as sqrt(v),
and clips the update to [-5, 5].  The gradient norm is global: it is taken
over every gradient before any leaf is updated.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_zip_map

Params = Any

# elements of one slice of a leaf in apply_updates / global_norm
SLICE_ELEMS = 1 << 24


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_bits: int = 32          # 32 (fp32 moments) or 8 (int8 + scales)
    block: int = 256              # quantization block size


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac (fp32)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


# --------------------------------------------------------- int8 moment codec
#
# Blocks run along the LAST dim only ([..., d] -> [..., d/bs, bs]), so the
# codes of a slice along the leading axis are that slice's codes.

def _block_size(last: int, block: int) -> int:
    for bs in (block, 128, 64, 32, 16, 8):
        if bs <= block and last % bs == 0:
            return bs
    return last


def _quant8(x: torch.Tensor, block: int, bs: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes [..., d/bs, bs], fp32 scales [..., d/bs, 1]); a true
    division by the scale, rounding half to even.  ``bs``: the block size
    of codes already laid out (a rank's block of a moment split along its
    last dim keeps the whole moment's blocks)."""
    if bs is None:
        bs = _block_size(x.shape[-1] if x.dim() else 1, block)
    if x.dim() == 0:
        x = x[None]
        bs = 1
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // bs, bs)
    scale = torch.amax(torch.abs(xb), dim=-1, keepdim=True) / 127.0
    q = torch.round(xb / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(shape)


# ------------------------------------------------------------------- states

class AdamState(NamedTuple):
    step: torch.Tensor            # int32 scalar on the parameters' device
    m: Params
    v: Params


def init_state(params: Params, cfg: AdamWConfig) -> AdamState:
    if cfg.state_bits == 8:
        def zq(p):
            q, s = _quant8(torch.zeros_like(p, dtype=torch.float32),
                           cfg.block)
            return {"q": q, "s": s}
        zeros = lambda: tree_map(zq, params)
    else:
        zeros = lambda: tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamState(step=step, m=zeros(), v=zeros())


def _slices(*xs: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching slices along the leading axis of tensors that share it, of
    at most SLICE_ELEMS elements of the first (one row where a row is
    larger); tensors of fewer than two dims come whole."""
    x0 = xs[0]
    if x0.dim() < 2:
        yield xs
        return
    rows = max(1, SLICE_ELEMS // max(x0[0].numel(), 1))
    for r in range(0, x0.shape[0], rows):
        yield tuple(x[r:r + rows] for x in xs)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    total = 0
    for x in tree_leaves(tree):
        sq = sum(torch.sum(torch.square(s.to(torch.float32)))
                 for (s,) in _slices(x))
        total = total + sq
    return torch.sqrt(total)


def apply_updates(params: Params, grads: Params, state: AdamState,
                  cfg: AdamWConfig, gnorm: Optional[torch.Tensor] = None
                  ) -> Tuple[Params, AdamState, Dict]:
    """One AdamW step: (new params, the state with its moments updated in
    place, {"lr", "gnorm"}).  ``gnorm``: the global gradient norm when
    ``grads`` are one rank's blocks (``trainer.make_sharded_train_step``);
    by default the norm of ``grads``."""
    step = state.step + 1
    lr = schedule(cfg, step)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    def new_param(p, u):
        u = u + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * u).to(p.dtype)

    def moments(m, v, g):
        """b1*m + (1-b1)*g and b2*v + (1-b2)*g*g, into m and v."""
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)

    if cfg.state_bits == 8:
        def upd(p, g, mq, vq):
            newp = torch.empty_like(p)
            for ps, gs, mqs, mss, vqs, vss, out in _slices(
                    p, g, mq["q"], mq["s"], vq["q"], vq["s"], newp):
                gs = gs.to(torch.float32) * scale
                m = _dequant8(mqs, mss, ps.shape)
                rms = _dequant8(vqs, vss, ps.shape)   # sqrt(v) stored
                v = rms * rms
                moments(m, v, gs)
                u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                # trust clip: bounds the blowup when a tiny v underflows
                # the int8 grid while its m survives
                u = torch.clamp(u, -5.0, 5.0)
                out.copy_(new_param(ps, u))
                for (q, s), x in (((mqs, mss), m),
                                  ((vqs, vss), torch.sqrt(v))):
                    nq, ns = _quant8(x, cfg.block, bs=q.shape[-1])
                    q.copy_(nq)
                    s.copy_(ns)
            return newp
    else:
        def upd(p, g, m, v):
            newp = torch.empty_like(p)
            for ps, gs, ms, vs, out in _slices(p, g, m, v, newp):
                gs = gs.to(torch.float32) * scale
                moments(ms, vs, gs)
                u = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps)
                out.copy_(new_param(ps, u))
            return newp

    with torch.no_grad():
        newp = tree_zip_map(upd, params, grads, state.m, state.v)
    return (newp, AdamState(step, state.m, state.v),
            {"lr": lr, "gnorm": gnorm})

"""Decoder-only LM transformer: GQA + RoPE + (Ge/Swi)GLU, dense or MoE FFN,
the port of ``repro.models.transformer``.

Layer parameters are stacked along a leading L axis, as the reference's
``vmap`` makes them, so carrying weights across is a copy; the layer loop
is a Python loop over L (the reference scans), with each layer
checkpointed when ``remat`` is set and gradients are on.  Entry points:

  forward / lm_loss — full-sequence causal LM (chunked attention)
  prefill           — run the prompt, return last-position logits and the
                      KV cache padded to ``max_len``
  decode_step       — one token against the cache

With ``cp_mesh`` (a rank mesh), ``forward`` and ``lm_loss`` take this
rank's batch block (batch sharded over ``cp_data_axes``, replicated over
the model axis) and run each layer's attention context-parallel
(``attention.context_parallel_attention``): each model peer attends for
its S/mp queries and the output is all-gathered back, so activations
outside attention stay replicated over the model axis; the loss is the
mean over every data rank.  ``prefill`` and ``decode_step`` ignore it, as
the reference's do.  The layer-boundary sharding (``act_pspec``, the
reference's XLA SPMD constraint over its ambient mesh) means a per-rank
program over a rank mesh: with ``act_pspec`` set, ``forward``,
``lm_loss`` and ``prefill`` take the mesh as ``mesh=`` and run
``transformer_sharded``'s program on this rank's blocks (``decode_step``
does with ``mesh=`` and the cache's specs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import require_rank_mesh
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    Params, apply_rope, dense_init, embed, embedding_init, rmsnorm,
    rmsnorm_init, rope_frequencies, tree_map,
)
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init
from repro_torch.utils import resolve_device
from repro_torch.utils.device import DeviceLike


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    act: str = "swiglu"              # "swiglu" | "geglu"
    rope_theta: float = 10000.0
    max_seq: int = 8192
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma multiplies embeddings by sqrt(d)
    moe: Optional[MoEConfig] = None
    attn_chunk: int = 512
    remat: bool = True
    dtype: Any = torch.float32
    # layer-boundary activation spec, (data, "model", None) (sequence
    # parallel) or (data, None, "model") (d_model sharded): the per-rank
    # programs of transformer_sharded.py over the rank mesh passed as mesh=
    act_pspec: Optional[tuple] = None
    # the reference fully unrolls its layer and chunk scans with it (its
    # cost analysis counts a while-loop body once); the port's layers and
    # chunks are Python loops already, so it changes nothing here
    unroll_scans: bool = False
    # context-parallel attention over a rank mesh's model axis, the batch
    # sharded over cp_data_axes (see attention.context_parallel_attention)
    cp_mesh: Any = None
    cp_data_axes: tuple = ("data",)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs)."""
        d, L = self.d_model, self.n_layers
        attn_p = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        if self.moe:
            E, Fe = self.moe.n_experts, self.moe.d_ff_expert
            ffn = d * E + 3 * E * d * Fe
            if self.moe.n_shared_experts:
                ffn += 3 * d * Fe * self.moe.n_shared_experts
        else:
            ffn = 3 * d * self.d_ff
        return L * (attn_p + ffn + 2 * d) + self.vocab * d + d

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        attn_p = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        Fe = self.moe.d_ff_expert
        ffn = d * self.moe.n_experts + 3 * d * Fe * (
            self.moe.top_k + self.moe.n_shared_experts)
        return L * (attn_p + ffn + 2 * d) + self.vocab * d + d


def _ranked(cfg: TransformerConfig, mesh) -> bool:
    """Whether a call runs the per-rank program (``act_pspec`` set); it
    then needs the rank mesh."""
    if cfg.act_pspec is None:
        if mesh is not None:
            raise ValueError("mesh= is for the per-rank program: set "
                             "act_pspec")
        return False
    require_rank_mesh(mesh, "TransformerConfig.act_pspec (pass mesh=)")
    return True


# ------------------------------------------------------------------- params

def init_params(gen: torch.Generator, cfg: TransformerConfig,
                device: DeviceLike = None) -> Params:
    """Layer parameters stacked along a leading L axis."""
    L, d = cfg.n_layers, cfg.d_model
    kw = {"dtype": cfg.dtype, "device": device}
    layers: Params = {
        "ln1": rmsnorm_init(d, lead=(L,), **kw),
        "ln2": rmsnorm_init(d, lead=(L,), **kw),
        "wq": dense_init(gen, d, cfg.q_dim, lead=(L,), **kw),
        "wk": dense_init(gen, d, cfg.kv_dim, lead=(L,), **kw),
        "wv": dense_init(gen, d, cfg.kv_dim, lead=(L,), **kw),
        "wo": dense_init(gen, cfg.q_dim, d, lead=(L,), **kw),
    }
    if cfg.moe is not None:
        layers["moe"] = moe_init(gen, d, cfg.moe, lead=(L,), **kw)
    else:
        layers["ffn"] = {
            "wi": dense_init(gen, d, cfg.d_ff, lead=(L,), **kw),
            "wg": dense_init(gen, d, cfg.d_ff, lead=(L,), **kw),
            "wo": dense_init(gen, cfg.d_ff, d, lead=(L,), **kw),
        }
    p: Params = {
        "embed": embedding_init(gen, cfg.vocab, d, **kw),
        "layers": layers,
        "final_ln": rmsnorm_init(d, **kw),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.vocab, **kw)
    return p


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views of the stacked tensors."""
    return tree_map(lambda x: x[i], params["layers"])


# ------------------------------------------------------------------ forward

def _glu(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    g = x @ p["wg"]["w"]
    h = x @ p["wi"]["w"]
    gate = F.gelu(g, approximate="tanh") if act == "geglu" else F.silu(g)
    return (gate * h) @ p["wo"]["w"]


def _embed_tokens(params: Params, tokens: torch.Tensor,
                  cfg: TransformerConfig) -> torch.Tensor:
    x = embed(params["embed"], tokens).to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    return x


def _logits(params: Params, x: torch.Tensor, cfg: TransformerConfig
            ) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T.to(cfg.dtype)
    return x @ params["lm_head"]["w"]


def _qkv(lp: Params, x: torch.Tensor, cfg: TransformerConfig, cos, sin,
         positions):
    """q [B,Hq,S,D], k and v [B,Hkv,S,D] of one layer, RoPE applied."""
    B, S, _ = x.shape
    h = rmsnorm(lp["ln1"], x)
    q = (h @ lp["wq"]["w"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"]["w"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["wv"]["w"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q.transpose(1, 2), cos, sin, positions[:, None, :])
    k = apply_rope(k.transpose(1, 2), cos, sin, positions[:, None, :])
    return q, k, v.transpose(1, 2)


def _ffn(lp: Params, x: torch.Tensor, cfg: TransformerConfig):
    """x + FFN(rmsnorm(x)) and the MoE aux loss (0 for a dense FFN)."""
    h = rmsnorm(lp["ln2"], x)
    if cfg.moe is not None:
        y, aux = moe_apply(lp["moe"], h, cfg.moe)
    else:
        y = _glu(lp["ffn"], h, cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def _cp_attention(q, k, v, cfg: TransformerConfig) -> torch.Tensor:
    """This model peer's S/mp slice of q, k and v through context-parallel
    attention, the output all-gathered back to the full sequence."""
    mesh = cfg.cp_mesh
    mp = mesh.shape["model"]
    S_loc = q.shape[2] // mp
    lo = C.axis_index("model", mesh) * S_loc
    ql, kl, vl = (t[:, :, lo:lo + S_loc] for t in (q, k, v))
    o = attn.context_parallel_attention(ql, kl, vl, mesh, causal=True,
                                        chunk=cfg.attn_chunk)
    return C.all_gather(o, "model", mesh, axis=2)


def _layer_fwd(lp: Params, x: torch.Tensor, cfg: TransformerConfig, cos, sin,
               positions) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q, k, v = _qkv(lp, x, cfg, cos, sin, positions)
    if cfg.cp_mesh is not None:
        o = _cp_attention(q, k, v, cfg)
    else:
        o = attn.chunked_attention(q, k, v, causal=True,
                                   chunk=min(cfg.attn_chunk, S))
    o = o.transpose(1, 2).reshape(B, S, cfg.q_dim)
    return _ffn(lp, x + o @ lp["wo"]["w"], cfg)


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], aux_loss); with ``cp_mesh``,
    this rank's batch block in and out; with ``act_pspec``, the per-rank
    program on ``mesh`` (its logits are this rank's vocabulary block)."""
    if _ranked(cfg, mesh):
        from repro_torch.models import transformer_sharded as ts
        return ts.forward(params, tokens, cfg, mesh)
    if cfg.cp_mesh is not None:
        require_rank_mesh(cfg.cp_mesh, "TransformerConfig.cp_mesh")
    B, S = tokens.shape
    dev = tokens.device
    x = _embed_tokens(params, tokens, cfg)
    cos, sin = rope_frequencies(cfg.head_dim, S, cfg.rope_theta, dev)
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if remat:
            x, a = checkpoint(_layer_fwd, lp, x, cfg, cos, sin, positions,
                              use_reentrant=False)
        else:
            x, a = _layer_fwd(lp, x, cfg, cos, sin, positions)
        aux = aux + a
    x = rmsnorm(params["final_ln"], x)
    return _logits(params, x, cfg), aux


def lm_loss(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    if _ranked(cfg, mesh):
        from repro_torch.models import transformer_sharded as ts
        return ts.lm_loss(params, tokens, targets, cfg, mesh)
    logits, aux = forward(params, tokens, cfg)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = torch.mean(logz - gold)
    if cfg.cp_mesh is not None:
        nll = C.pmean(nll, cfg.cp_data_axes, cfg.cp_mesh)
    return nll + aux


# -------------------------------------------------------------- serving path

def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  dtype: Optional[torch.dtype] = None,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            max_len: int, mesh=None):
    """Run the prompt; returns (last-position logits [B, V], KV cache with
    ``k``/``v`` [L, B, Hkv, max_len, D] zero past the prompt and ``len``
    [B] int32); with ``act_pspec``, this rank's blocks on ``mesh``."""
    if _ranked(cfg, mesh):
        from repro_torch.models import transformer_sharded as ts
        return ts.prefill(params, tokens, cfg, max_len, mesh)
    B, S = tokens.shape
    dev = tokens.device
    x = _embed_tokens(params, tokens, cfg)
    cos, sin = rope_frequencies(cfg.head_dim, max_len, cfg.rope_theta, dev)
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, max_len, cfg.head_dim)
    ks = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    vs = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        q, k, v = _qkv(lp, x, cfg, cos, sin, positions)
        o = attn.chunked_attention(q, k, v, causal=True,
                                   chunk=min(cfg.attn_chunk, S))
        o = o.transpose(1, 2).reshape(B, S, cfg.q_dim)
        x, _ = _ffn(lp, x + o @ lp["wo"]["w"], cfg)
        ks[i, :, :, :S] = k
        vs[i, :, :, :S] = v
    x = rmsnorm(params["final_ln"], x)
    logits = _logits(params, x[:, -1], cfg)
    cache = {"k": ks, "v": vs,
             "len": torch.full((B,), S, dtype=torch.int32, device=dev)}
    return logits, cache


def decode_step(params: Params, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], cfg: TransformerConfig,
                mesh=None, cache_spec=None):
    """One decode step.  token [B] int; cache from init_kv_cache/prefill
    (not modified: the step returns a new one).  With ``mesh``, this
    rank's blocks of the token and of the cache under ``cache_spec``
    (``launch.sharding.kv_cache_shardings``), split-KV
    (``transformer_sharded.decode_step``).

    Each row writes its new key and value at position ``len``, by adding
    them there as the reference's one-hot write does; a row whose ``len``
    has reached ``max_len`` writes nothing and reads RoPE at the last
    position, as the reference's one-hot and clamped gather give it."""
    if mesh is not None:
        from repro_torch.models import transformer_sharded as ts
        return ts.decode_step(params, token, cache, cfg, mesh, cache_spec)
    B = token.shape[0]
    dev = token.device
    max_len = cache["k"].shape[3]
    x = _embed_tokens(params, token[:, None], cfg)[:, 0]
    cos, sin = rope_frequencies(cfg.head_dim, max_len, cfg.rope_theta, dev)
    pos = cache["len"].long()                                 # [B]
    at = torch.clamp_max(pos, max_len - 1)
    inside = (pos < max_len)[:, None, None]
    rows = torch.arange(B, device=dev)
    new_k, new_v = cache["k"].clone(), cache["v"].clone()
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = rmsnorm(lp["ln1"], x)
        q = (h @ lp["wq"]["w"]).reshape(B, cfg.n_heads, cfg.head_dim)
        k = (h @ lp["wk"]["w"]).reshape(B, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ lp["wv"]["w"]).reshape(B, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q[:, :, None, :], cos, sin, at[:, None, None])[:, :, 0]
        k = apply_rope(k[:, :, None, :], cos, sin, at[:, None, None])[:, :, 0]
        kc, vc = new_k[i], new_v[i]                           # views
        kc[rows, :, at] += k * inside
        vc[rows, :, at] += v * inside
        o = attn.decode_attention(q, kc, vc, pos + 1)
        x = x + o.reshape(B, cfg.q_dim) @ lp["wo"]["w"]
        x, _ = _ffn(lp, x[:, None, :], cfg)
        x = x[:, 0]
    x = rmsnorm(params["final_ln"], x)
    logits = _logits(params, x, cfg)
    return logits, {"k": new_k, "v": new_v, "len": cache["len"] + 1}

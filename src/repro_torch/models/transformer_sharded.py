"""The transformer's per-rank programs over a rank mesh: what the
reference's XLA SPMD partitioner makes of ``act_pspec``,
``dispatch_pspec`` and the parameter shardings (``launch/sharding.py``).

Each function takes this rank's blocks (parameters under the sharding
rules, the batch over the data axes) and returns this rank's blocks;
``specs`` is the rules' spec tree of the parameters (:func:`param_specs`).
Every leaf is gathered at use over the axes that shard it, except where a
layer keeps the model axis's block to work on (tensor parallelism); a
gather's backward is the reduce-scatter of the gradient.

``act_pspec`` forms:

* ``(data, "model", None)``: sequence-parallel layer boundaries.
  Activations cross layers as ``[B/dp, S/mp, D]``.  With heads that split
  over the model axis, each layer all-gathers S over it, runs
  column-parallel ``wq/wk/wv/wi/wg`` and row-parallel ``wo`` from the
  rank's blocks and reduce-scatters back over S (Megatron TP+SP); a
  rank's query heads read the KV heads they map to, gathered in full when
  the KV heads do not split as the query heads do (4 KV heads over 16
  model ranks).  With ``cp_mesh`` (heads that do not split), attention is
  context-parallel on the rank's S slice and the weights are gathered.
  The MoE FFN is the expert-parallel layer on the S slice
  (``seq_sharded``).
* ``(data, None, "model")``: d_model-sharded boundaries (S does not split
  over the model axis): each layer gathers D on entry, runs on the whole
  sequence with gathered weights and keeps the rank's D block on exit.

The embedding and the head are vocab-parallel when the rules shard the
vocabulary over the model axis: a masked lookup of the rank's rows summed
over the model axis (reduce-scattered over S or D at the first boundary),
and logits of the rank's vocabulary block with a log-softmax whose max
and sum run over the model axis.

The loss a rank returns is the global loss (equal on every rank); its
gradient with respect to a rank's blocks, summed over the ranks that hold
a block (``sharding.sum_over_replicas``), is the gradient of the global
loss once the loss is divided by the mesh size
(``trainer.make_sharded_train_step``).

Decode: the cache ``[L, B, Hkv, S, Dh]`` is split over the data axes by
batch and over the model axis (or, B = 1, every axis) by sequence
(``kv_cache_shardings``); attention is split-KV
(``decode_attention_partial`` on the rank's slice, ``combine_partials``
over the axes the sequence splits on), and the new key and value are
written by the rank that owns position ``len``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.graphops.distributed import flat_axis_index
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import (
    Mesh, axis_product, data_axes, require_rank_mesh,
)
from repro_torch.launch.sharding import entry_axes, params_shardings
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    Params, apply_rope, rmsnorm, rope_frequencies,
)
from repro_torch.models.moe_sharded import moe_apply_pjit, moe_apply_sharded
from repro_torch.models.transformer import (
    TransformerConfig, _glu, init_params,
)

MODEL = "model"


def param_specs(cfg: TransformerConfig, mesh: Mesh):
    """The rules' spec of every parameter of ``cfg`` on ``mesh``."""
    return params_shardings(init_params(None, cfg, device="meta"), mesh)


def gather_block(x: torch.Tensor, sp, mesh: Mesh, keep: Tuple[str, ...] = ()
                 ) -> torch.Tensor:
    """A block gathered over every axis its spec shards it on but those
    in ``keep`` (which stay this rank's block)."""
    for d, entry in enumerate(sp):
        axes = entry_axes(entry)
        if not axes or all(a in keep for a in axes):
            continue
        if any(a in keep for a in axes):
            raise ValueError(f"dim {d} shards over {axes}: cannot keep "
                             f"{keep} of it and gather the rest")
        x = C.all_gather(x, axes, mesh, axis=d)
    return x


def _layer_specs(specs):
    """Per-layer specs of the stacked ``layers`` leaves (dim 0 dropped)."""
    if isinstance(specs, dict):
        return {k: _layer_specs(v) for k, v in specs.items()}
    return tuple(specs[1:])


def _leaf(tree, path: str):
    for k in path.split("."):
        tree = tree[k]
    return tree


class _Rank:
    """One rank's view of a cell: config, mesh, specs, its coordinates."""

    def __init__(self, cfg: TransformerConfig, mesh: Mesh, specs):
        self.cfg, self.mesh, self.specs = cfg, require_rank_mesh(
            mesh, "the transformer's rank programs"), specs
        self.lspecs = _layer_specs(specs["layers"])
        self.daxes = data_axes(mesh)
        self.dp = axis_product(mesh, self.daxes)
        self.mp = mesh.shape[MODEL]
        self.m = C.axis_index(MODEL, mesh)
        self.axes = tuple(mesh.axis_names)

    def full(self, lp, path: str) -> torch.Tensor:
        """A layer leaf gathered over every axis."""
        return gather_block(_leaf(lp, path), _leaf(self.lspecs, path),
                            self.mesh)

    def cols(self, lp, path: str, what: str) -> torch.Tensor:
        """A [din, dout] layer weight whose columns this rank keeps."""
        sp = _leaf(self.lspecs, path)
        if sp[-1] != MODEL:
            raise ValueError(f"{what}: {path} {sp} is not column-sharded "
                             f"over the model axis ({self.mp} ranks)")
        return gather_block(_leaf(lp, path), sp, self.mesh, keep=(MODEL,))

    def rows(self, lp, path: str, what: str) -> torch.Tensor:
        """A [din, dout] layer weight whose rows this rank keeps."""
        sp = _leaf(self.lspecs, path)
        if sp[-2] != MODEL:
            raise ValueError(f"{what}: {path} {sp} is not row-sharded over "
                             f"the model axis ({self.mp} ranks)")
        return gather_block(_leaf(lp, path), sp, self.mesh, keep=(MODEL,))


def _mode(cfg: TransformerConfig) -> str:
    ap = cfg.act_pspec
    if ap is None or len(ap) != 3:
        raise ValueError(f"act_pspec {ap}: a train or prefill step over a "
                         f"rank mesh takes (data, 'model', None) or "
                         f"(data, None, 'model')")
    if ap[1] == MODEL and ap[2] is None:
        return "seq"
    if ap[1] is None and ap[2] == MODEL:
        return "dmodel"
    raise ValueError(f"act_pspec {ap}: only (data, 'model', None) and "
                     f"(data, None, 'model') have a per-rank program")


# ----------------------------------------------------- embedding and head

def _embed(r: _Rank, params: Params, ids: torch.Tensor
           ) -> Tuple[torch.Tensor, bool]:
    """(rows of ``ids``, whether they are this rank's vocab part): a
    vocab-sharded table gives each rank its rows' embeddings and zeros
    elsewhere, to be summed over the model axis."""
    sp = r.specs["embed"]["table"]
    tab = gather_block(params["embed"]["table"], sp, r.mesh, keep=(MODEL,))
    if sp[0] != MODEL:
        return tab[ids.long()], False
    Vl = tab.shape[0]
    loc = ids.long() - r.m * Vl
    inside = (loc >= 0) & (loc < Vl)
    rows = tab[torch.clamp(loc, 0, Vl - 1)]
    return rows * inside[..., None].to(rows.dtype), True


def _scale(x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    x = x.to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    return x


def _head(r: _Rank, params: Params, x: torch.Tensor
          ) -> Tuple[torch.Tensor, bool]:
    """(logits of this rank's vocab block, whether the vocab is split)."""
    cfg = r.cfg
    if cfg.tie_embeddings:
        sp = r.specs["embed"]["table"]
        w = gather_block(params["embed"]["table"], sp, r.mesh,
                         keep=(MODEL,)).T.to(cfg.dtype)
        return x @ w, sp[0] == MODEL
    sp = r.specs["lm_head"]["w"]
    w = gather_block(params["lm_head"]["w"], sp, r.mesh, keep=(MODEL,))
    return x @ w, sp[1] == MODEL


def _full_logits(r: _Rank, params: Params, x: torch.Tensor) -> torch.Tensor:
    logits, split = _head(r, params, x)
    return C.all_gather(logits, MODEL, r.mesh, axis=-1) if split else logits


def _nll_sum(r: _Rank, logits: torch.Tensor, targets: torch.Tensor,
             split: bool) -> torch.Tensor:
    """This rank's share of the summed NLL: over the model axis the shares
    sum to each token's ``logsumexp - gold`` once."""
    logits = logits.to(torch.float32)
    tg = targets.long()
    if not split:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tg[..., None])[..., 0]
        return torch.sum(lse - gold) / r.mp
    m = C.pmax(torch.amax(logits, dim=-1), MODEL, r.mesh)
    se = C.psum(torch.sum(torch.exp(logits - m[..., None]), dim=-1), MODEL,
                r.mesh)
    lse = m + torch.log(se)
    Vl = logits.shape[-1]
    loc = tg - r.m * Vl
    inside = (loc >= 0) & (loc < Vl)
    gold = torch.gather(logits, -1, torch.clamp(loc, 0, Vl - 1)[..., None])
    return torch.sum(lse / r.mp - gold[..., 0] * inside)


# --------------------------------------------------------------- attention

def _kv_heads(cfg: TransformerConfig, h0: int, hn: int) -> Tuple[int, int]:
    """The KV heads [g0, g1) that query heads [h0, h0 + hn) read."""
    rep = cfg.n_heads // cfg.n_kv_heads
    return h0 // rep, (h0 + hn - 1) // rep + 1


def _group(q, k, v, cfg: TransformerConfig, h0: int, g0: int):
    """k and v laid out for ``q``'s heads: as they are when the local
    query heads group evenly over the local KV heads, else one KV head a
    query head."""
    hn, gn = q.shape[1], k.shape[1]
    rep = cfg.n_heads // cfg.n_kv_heads
    want = [(h0 + j) // rep - g0 for j in range(hn)]
    if hn % gn == 0 and want == [j // (hn // gn) for j in range(hn)]:
        return k, v
    return k[:, want], v[:, want]


def _attn_tp(r: _Rank, lp, hf, cos, sin, pos) -> torch.Tensor:
    """Column/row-parallel attention of this rank's query heads on the
    whole sequence: ``hf`` [B, S, D] normed in, the partial ``o @ wo``
    [B, S, D] out (to be summed over the model axis)."""
    cfg = r.cfg
    B, S, _ = hf.shape
    Dh = cfg.head_dim
    if cfg.n_heads % r.mp:
        raise ValueError(f"{cfg.n_heads} heads do not split over "
                         f"{r.mp} model ranks: set cp_mesh")
    hn = cfg.n_heads // r.mp
    h0 = r.m * hn
    g0, g1 = _kv_heads(cfg, h0, hn)
    q = (hf @ r.cols(lp, "wq.w", "TP attention")).reshape(B, S, hn, Dh)
    kv_sp = _leaf(r.lspecs, "wk.w")
    if (kv_sp[-1] == MODEL and cfg.n_kv_heads % r.mp == 0):
        wk, wv = (r.cols(lp, f"{n}.w", "TP attention") for n in ("wk", "wv"))
    else:
        wk, wv = (r.full(lp, f"{n}.w")[:, g0 * Dh:g1 * Dh]
                  for n in ("wk", "wv"))
    k = (hf @ wk).reshape(B, S, g1 - g0, Dh)
    v = (hf @ wv).reshape(B, S, g1 - g0, Dh)
    q = apply_rope(q.transpose(1, 2), cos, sin, pos[:, None, :])
    k = apply_rope(k.transpose(1, 2), cos, sin, pos[:, None, :])
    k, v = _group(q, k, v.transpose(1, 2), cfg, h0, g0)
    o = attn.chunked_attention(q, k, v, causal=True,
                               chunk=min(cfg.attn_chunk, S))
    o = o.transpose(1, 2).reshape(B, S, hn * Dh)
    return o @ r.rows(lp, "wo.w", "TP attention")


def _kv_full(r: _Rank, lp, h, cos, sin, pos):
    """k and v of every KV head from gathered weights, RoPE at ``pos``."""
    cfg = r.cfg
    B, S, _ = h.shape
    k = (h @ r.full(lp, "wk.w")).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ r.full(lp, "wv.w")).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    k = apply_rope(k.transpose(1, 2), cos, sin, pos[:, None, :])
    return k, v.transpose(1, 2)


def _qkv_full(r: _Rank, lp, h, cos, sin, pos):
    """q, k, v of every head from gathered weights, RoPE at ``pos``."""
    cfg = r.cfg
    B, S, _ = h.shape
    q = (h @ r.full(lp, "wq.w")).reshape(B, S, cfg.n_heads, cfg.head_dim)
    q = apply_rope(q.transpose(1, 2), cos, sin, pos[:, None, :])
    return (q, *_kv_full(r, lp, h, cos, sin, pos))


# -------------------------------------------------------------------- FFN

def _moe_params(r: _Rank, lp, experts) -> Params:
    """The MoE layer's parameters as the rank layers take them: router and
    shared experts gathered, ``experts(name)`` for wi, wg and wo."""
    p = {"router": {"w": r.full(lp, "moe.router.w")},
         **{n: experts(n) for n in ("wi", "wg", "wo")}}
    if "shared" in lp["moe"]:
        p["shared"] = {n: r.full(lp, f"moe.shared.{n}")
                       for n in ("wi", "wg", "wo")}
    return p


def _moe_pjit(r: _Rank, lp, h, tok_axes) -> torch.Tensor:
    """``dispatch_pspec``'s layer on decode tokens [B, D]: the experts'
    blocks gathered over the data axes, kept over the model axis."""
    sp = r.lspecs["moe"]
    split = ((sp["wi"][0], sp["wo"][0]) if r.cfg.moe.dispatch_pspec[0]
             else (sp["wi"][2], sp["wo"][1]))
    if r.mp > 1 and split != (MODEL, MODEL):
        raise ValueError(f"dispatch_pspec {r.cfg.moe.dispatch_pspec}: the "
                         f"experts {sp['wi']} / {sp['wo']} are not split "
                         f"over the model axis where its layer sums them")
    p = _moe_params(r, lp, lambda n: gather_block(
        lp["moe"][n], sp[n], r.mesh, keep=(MODEL,)))
    return moe_apply_pjit(p, h[:, None, :], r.cfg.moe, r.mesh,
                          tok_axes)[0][:, 0]


def _moe_sharded(r: _Rank, lp, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel layer (``MoEConfig.mesh``) on this rank's
    tokens, the experts' data-axis blocks gathered inside it."""
    mcfg = r.cfg.moe
    sp = r.lspecs["moe"]["wi"]
    if sp[0] != MODEL or sp[2] is not None:
        raise ValueError(f"expert-parallel MoE: the experts {sp} are not "
                         f"split as (model, data, None)")
    p = _moe_params(r, lp, lambda n: lp["moe"][n])
    return moe_apply_sharded(p, x, mcfg, r.mesh, mcfg.data_axes,
                             mcfg.model_axis, weight_axes=entry_axes(sp[1]))


def _ffn_full(r: _Rank, lp, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN of normed ``h`` with gathered weights (or the MoE layer)."""
    cfg = r.cfg
    if cfg.moe is not None:
        if cfg.moe.mesh is not None:
            return _moe_sharded(r, lp, h)
        raise ValueError("a MoE FFN over a rank mesh needs MoEConfig.mesh "
                         "(train, prefill) or dispatch_pspec (decode)")
    w = {n: {"w": r.full(lp, f"ffn.{n}.w")} for n in ("wi", "wg", "wo")}
    return _glu(w, h, cfg.act), h.new_zeros((), dtype=torch.float32)


# ------------------------------------------------------------ layer bodies

def _layer_seq(lp, x, r: _Rank, cos, sin, pos_full, pos_loc):
    """One layer on sequence-parallel boundaries: x [B, S/mp, D]."""
    cfg, mesh = r.cfg, r.mesh
    B, S_l, D = x.shape
    h = rmsnorm({"g": r.full(lp, "ln1.g")}, x)
    if cfg.cp_mesh is not None:
        q, k, v = _qkv_full(r, lp, h, cos, sin, pos_loc)
        o = attn.context_parallel_attention(q, k, v, mesh, causal=True,
                                            chunk=cfg.attn_chunk)
        o = o.transpose(1, 2).reshape(B, S_l, cfg.q_dim)
        x = x + o @ r.full(lp, "wo.w")
    else:
        hf = C.all_gather(h, MODEL, mesh, axis=1)
        x = x + C.psum_scatter(_attn_tp(r, lp, hf, cos, sin, pos_full),
                               MODEL, mesh, axis=1)
    h2 = rmsnorm({"g": r.full(lp, "ln2.g")}, x)
    if cfg.moe is not None:
        if cfg.moe.mesh is None or not cfg.moe.seq_sharded:
            raise ValueError("sequence-parallel boundaries with a MoE FFN "
                             "need the expert-parallel layer with "
                             "seq_sharded (MoEConfig.mesh)")
        y, aux = _moe_sharded(r, lp, h2)
        return x + y, aux
    if cfg.cp_mesh is not None:
        y, aux = _ffn_full(r, lp, h2)
        return x + y, aux
    hf2 = C.all_gather(h2, MODEL, mesh, axis=1)
    g = hf2 @ r.cols(lp, "ffn.wg.w", "TP FFN")
    hi = hf2 @ r.cols(lp, "ffn.wi.w", "TP FFN")
    gate = (torch.nn.functional.gelu(g, approximate="tanh")
            if cfg.act == "geglu" else torch.nn.functional.silu(g))
    y = (gate * hi) @ r.rows(lp, "ffn.wo.w", "TP FFN")
    return (x + C.psum_scatter(y, MODEL, mesh, axis=1),
            h2.new_zeros((), dtype=torch.float32))


def _layer_dmodel(lp, x, r: _Rank, cos, sin, pos_full, pos_loc):
    """One layer on d_model-sharded boundaries: x [B, S, D/mp]."""
    cfg = r.cfg
    Dl = x.shape[2]
    xf = C.all_gather(x, MODEL, r.mesh, axis=2)
    B, S, _ = xf.shape
    h = rmsnorm({"g": r.full(lp, "ln1.g")}, xf)
    q, k, v = _qkv_full(r, lp, h, cos, sin, pos_full)
    o = attn.chunked_attention(q, k, v, causal=True,
                               chunk=min(cfg.attn_chunk, S))
    xf = xf + o.transpose(1, 2).reshape(B, S, cfg.q_dim) @ r.full(lp, "wo.w")
    y, aux = _ffn_full(r, lp, rmsnorm({"g": r.full(lp, "ln2.g")}, xf))
    return (xf + y).narrow(2, r.m * Dl, Dl), aux


def _boundary_in(r: _Rank, params, tokens, mode: str) -> torch.Tensor:
    """The embedded tokens as the first boundary holds them."""
    dim = 1 if mode == "seq" else 2
    x, split = _embed(r, params, tokens)
    if split:
        x = C.psum_scatter(x, MODEL, r.mesh, axis=dim)
    else:
        n = x.shape[dim] // r.mp
        x = x.narrow(dim, r.m * n, n)
    return _scale(x, r.cfg)


def _check_split(r: _Rank, S: int, mode: str) -> None:
    if mode == "seq" and S % r.mp:
        raise ValueError(f"sequence-parallel boundaries: S = {S} does not "
                         f"split over {r.mp} model ranks")
    if mode == "dmodel" and r.cfg.d_model % r.mp:
        raise ValueError(f"d_model-sharded boundaries: d_model = "
                         f"{r.cfg.d_model} does not split over {r.mp} model "
                         f"ranks")


def _layers(params, x, r: _Rank, mode: str, S: int, remat: bool):
    """The layer loop; returns the last boundary and the summed aux."""
    cfg = r.cfg
    dev = x.device
    B = x.shape[0]
    cos, sin = rope_frequencies(cfg.head_dim, S, cfg.rope_theta, dev)
    pos_full = torch.arange(S, device=dev)[None, :].expand(B, S)
    S_l = S // r.mp
    pos_loc = (r.m * S_l + torch.arange(S_l, device=dev))[None, :].expand(
        B, S_l)
    body = _layer_seq if mode == "seq" else _layer_dmodel
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    layers = _unbind(params["layers"])
    for i in range(cfg.n_layers):
        lp = _index(layers, i)
        args = (lp, x, r, cos, sin, pos_full, pos_loc)
        if remat:
            x, a = checkpoint(body, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = body(*args)
        aux = aux + a
    return x, aux


def _unbind(tree):
    """Every stacked layer leaf cut into its L layers at once: the
    backward stacks the L gradients into one buffer, where indexing each
    layer would give each its own zero-filled [L, ...] gradient."""
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return tree.unbind(0)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _final_full(r: _Rank, params, x, mode: str) -> torch.Tensor:
    """The last boundary normed and gathered to [B, S, D] on every model
    rank."""
    if mode == "seq":
        x = rmsnorm({"g": params["final_ln"]["g"]}, x)
        return C.all_gather(x, MODEL, r.mesh, axis=1)
    x = C.all_gather(x, MODEL, r.mesh, axis=2)
    return rmsnorm({"g": params["final_ln"]["g"]}, x)


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh: Mesh, specs=None):
    """This rank's logits block [B/dp, S, V/mp] (the whole vocabulary when
    it does not split) and the aux loss; tokens [B/dp, S]."""
    r = _Rank(cfg, mesh, specs or param_specs(cfg, mesh))
    mode = _mode(cfg)
    S = tokens.shape[1]
    _check_split(r, S, mode)
    x = _boundary_in(r, params, tokens, mode)
    x, aux = _layers(params, x, r, mode, S,
                     cfg.remat and torch.is_grad_enabled())
    logits, _ = _head(r, params, _final_full(r, params, x, mode))
    return logits, aux


def lm_loss(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: TransformerConfig, mesh: Mesh, specs=None) -> torch.Tensor:
    """The global mean NLL plus the aux loss, equal on every rank, from
    this rank's blocks (tokens and targets [B/dp, S])."""
    r = _Rank(cfg, mesh, specs or param_specs(cfg, mesh))
    mode = _mode(cfg)
    B_l, S = tokens.shape
    _check_split(r, S, mode)
    x = _boundary_in(r, params, tokens, mode)
    x, aux = _layers(params, x, r, mode, S,
                     cfg.remat and torch.is_grad_enabled())
    logits, split = _head(r, params, _final_full(r, params, x, mode))
    total = C.psum(_nll_sum(r, logits, targets, split), r.axes, mesh)
    return total / float(B_l * r.dp * S) + aux


# ----------------------------------------------------------------- serving

def prefill(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            max_len: int, mesh: Mesh, specs=None):
    """This rank's part of ``transformer.prefill``: (last-position logits
    [B/dp, V], the cache blocks under ``kv_cache_shardings``: k and v
    [L, B/dp, Hkv, S/mp, Dh] on sequence-parallel boundaries, the whole S
    on d_model-sharded ones, ``len`` [B/dp])."""
    r = _Rank(cfg, mesh, specs or param_specs(cfg, mesh))
    mode = _mode(cfg)
    B, S = tokens.shape
    _check_split(r, S, mode)
    if max_len != S:
        raise ValueError(f"a prefill step over a rank mesh fills the cache "
                         f"to its end: max_len {max_len} != S {S}")
    dev = tokens.device
    cos, sin = rope_frequencies(cfg.head_dim, max_len, cfg.rope_theta, dev)
    pos_full = torch.arange(S, device=dev)[None, :].expand(B, S)
    S_l = S // r.mp
    pos_loc = (r.m * S_l + torch.arange(S_l, device=dev))[None, :].expand(
        B, S_l)
    x = _boundary_in(r, params, tokens, mode)
    ks, vs = [], []
    layers = _unbind(params["layers"])
    for i in range(cfg.n_layers):
        lp = _index(layers, i)
        if mode == "seq":
            h = rmsnorm({"g": r.full(lp, "ln1.g")}, x)
            k, v = _kv_full(r, lp, h, cos, sin, pos_loc)
            x, _ = _layer_seq(lp, x, r, cos, sin, pos_full, pos_loc)
        else:
            xf = C.all_gather(x, MODEL, mesh, axis=2)
            h = rmsnorm({"g": r.full(lp, "ln1.g")}, xf)
            k, v = _kv_full(r, lp, h, cos, sin, pos_full)
            x, _ = _layer_dmodel(lp, x, r, cos, sin, pos_full, pos_loc)
        ks.append(k)
        vs.append(v)
    if mode == "seq":
        x = rmsnorm({"g": params["final_ln"]["g"]}, x)
        last = C.all_gather(x[:, -1:], MODEL, mesh, axis=1)[:, -1]
    else:
        last = _final_full(r, params, x[:, -1:], mode)[:, 0]
    logits = _full_logits(r, params, last)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "len": torch.full((B,), S, dtype=torch.int32, device=dev)}
    return logits, cache


def decode_step(params: Params, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], cfg: TransformerConfig,
                mesh: Mesh, cache_spec, specs=None):
    """This rank's part of ``transformer.decode_step``: token [B/dp] (or
    [B] on every rank), the cache blocks under ``cache_spec``
    (``kv_cache_shardings``); returns (logits [B/dp, V], the new cache
    blocks)."""
    r = _Rank(cfg, mesh, specs or param_specs(cfg, mesh))
    B = token.shape[0]
    dev = token.device
    seq_axes = entry_axes(cache_spec["k"][3])
    S_l = cache["k"].shape[3]
    lo = flat_axis_index(seq_axes, mesh) * S_l if seq_axes else 0
    max_len = S_l * axis_product(mesh, seq_axes)
    tok_axes = entry_axes(cache_spec["k"][1])
    x, split = _embed(r, params, token)
    if split:
        x = C.psum(x, MODEL, mesh)
    x = _scale(x, cfg)
    cos, sin = rope_frequencies(cfg.head_dim, max_len, cfg.rope_theta, dev)
    pos = cache["len"].long()
    at = torch.clamp_max(pos, max_len - 1)
    loc = at - lo
    mine = ((pos < max_len) & (loc >= 0) & (loc < S_l))[:, None, None]
    loc = torch.clamp(loc, 0, S_l - 1)
    valid = (lo + torch.arange(S_l, device=dev))[None, :] < (pos + 1)[:, None]
    rows = torch.arange(B, device=dev)
    new_k, new_v = cache["k"].clone(), cache["v"].clone()
    layers = _unbind(params["layers"])
    for i in range(cfg.n_layers):
        lp = _index(layers, i)
        h = rmsnorm({"g": r.full(lp, "ln1.g")}, x)
        q = (h @ r.full(lp, "wq.w")).reshape(B, cfg.n_heads, cfg.head_dim)
        k = (h @ r.full(lp, "wk.w")).reshape(B, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ r.full(lp, "wv.w")).reshape(B, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q[:, :, None, :], cos, sin, at[:, None, None])[:, :, 0]
        k = apply_rope(k[:, :, None, :], cos, sin, at[:, None, None])[:, :, 0]
        kc, vc = new_k[i], new_v[i]
        kc[rows, :, loc] += k * mine
        vc[rows, :, loc] += v * mine
        if seq_axes:
            num, den, mx = attn.decode_attention_partial(q, kc, vc, valid)
            o = attn.combine_partials(num, den, mx, seq_axes, mesh
                                      ).to(cfg.dtype)
        else:
            o = attn.decode_attention(q, kc, vc, pos + 1)
        x = x + o.reshape(B, cfg.q_dim) @ r.full(lp, "wo.w")
        h2 = rmsnorm({"g": r.full(lp, "ln2.g")}, x)
        if cfg.moe is not None:
            if cfg.moe.dispatch_pspec is None:
                raise ValueError("a MoE decode step over a rank mesh needs "
                                 "dispatch_pspec")
            y = _moe_pjit(r, lp, h2, tok_axes)
        else:
            y, _ = _ffn_full(r, lp, h2)
        x = x + y
    x = rmsnorm({"g": params["final_ln"]["g"]}, x)
    logits = _full_logits(r, params, x)
    return logits, {"k": new_k, "v": new_v, "len": cache["len"] + 1}


def with_mesh_defaults(cfg: TransformerConfig) -> TransformerConfig:
    """``cfg`` without the rank-program settings (for its single-process
    twin)."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, mesh=None, dispatch_pspec=None,
                                  seq_sharded=False)
    return dataclasses.replace(cfg, act_pspec=None, cp_mesh=None, moe=moe)

"""Per-(arch x shape) cells: a per-rank step, the global input shapes, the
specs of every input and output.  The port of ``repro.launch.steps``,
which the dry run (``launch/dryrun.py``) and the roofline
(``roofline/analysis.py``) consume.

The reference hands XLA a global step function, ``ShapeDtypeStruct``
arguments and shardings, and its SPMD partitioner makes the program each
device runs.  Eager PyTorch has no partitioner, so a port cell carries
that per-device program itself: ``fn`` takes this rank's blocks of the
arguments (``args``, the **global** shapes as ``meta`` tensors in the
reference's pytree, cut by ``in_specs``) and returns this rank's blocks of
the results (``out_specs``).  It runs over a rank mesh: gloo or NCCL ranks
(``launch.mesh.make_rank_mesh``), or a meta mesh
(``launch.mesh.make_meta_mesh``) on ``meta`` tensors for counting.  A cell
built on a shape-only mesh (``make_production_mesh``) holds the same
shapes and specs, and its ``fn`` raises when called.

Every config decision of the reference's cells is taken under the same
guards (``act_pspec``, ``cp_mesh``, the MoE mesh and ``seq_sharded``,
``n_experts_alloc``, ``dispatch_pspec``, PNA in bf16 above 10^7 edges,
DimeNet's triplet cap, the node and edge padding, the 8-bit AdamW state of
qwen3-moe), and ``model_flops_per_step`` is the reference's formula.
:func:`global_inputs` draws a cell's inputs from a seed and
:func:`local_inputs` cuts a rank's blocks of them, so the cell executes;
``twin`` runs the same step in one process on the global inputs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.shapes import (
    GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, GNNShape, LMShape, RecsysShape,
)
from repro_torch.graphops.distributed import RowPartition
from repro_torch.graphops.sampler import max_subgraph_size
from repro_torch.launch.mesh import Mesh, axis_product, data_axes
from repro_torch.launch.sharding import (
    batch_sharding, gather_full, kv_cache_shardings, local_block,
    params_shardings, spec,
)
from repro_torch.models import transformer as tfm
from repro_torch.models import transformer_sharded as ts
from repro_torch.models.common import tree_map
from repro_torch.models.gnn import dimenet as dn
from repro_torch.models.gnn import mace as mc
from repro_torch.models.gnn import nequip as nq
from repro_torch.models.gnn import pna as pn
from repro_torch.models.gnn.graphdata import (
    GraphBatch, build_triplets, partitioned,
)
from repro_torch.models.recsys import mind as mi
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import (
    TrainState, init_train_state, make_sharded_train_step, make_train_step,
)
from repro_torch.utils import resolve_device, round_up
from repro_torch.utils.device import DeviceLike

I32 = torch.int32
F32 = torch.float32


def meta(shape, dtype=F32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclass
class LoweringCell:
    arch_id: str
    shape_name: str
    kind: str                      # train | prefill | decode | serve | ...
    fn: Callable                   # the per-rank step, on this rank's blocks
    args: Tuple                    # global shapes, meta tensors
    in_specs: Tuple
    out_specs: Any
    model_flops_per_step: float    # 6*N*D (dense) / 6*N_active*D (MoE)
    note: str = ""
    cfg: Any = None                # the model config the cell decided
    twin: Optional[Callable] = None  # the same step in one process


def _adam_cfg(arch_id: str) -> opt.AdamWConfig:
    bits = 8 if arch_id == "qwen3-moe-235b-a22b" else 32
    return opt.AdamWConfig(state_bits=bits)


def _replicated_like(tree):
    return tree_map(lambda _: spec(), tree)


def _state_specs(state: TrainState, mesh: Mesh, pspecs) -> TrainState:
    """Parameters under ``pspecs``, moments under the rules (as the
    reference shards them, 8-bit codes and scales inheriting their
    parameter's spec), the step replicated."""
    return TrainState(
        params=pspecs,
        opt_state=opt.AdamState(
            step=spec(), m=params_shardings(state.opt_state.m, mesh),
            v=params_shardings(state.opt_state.v, mesh)),
        ef=None)


def _metrics_specs() -> dict:
    return {"loss": spec(), "lr": spec(), "gnorm": spec()}


# =============================================================== LM family

def _lm_model_flops(cfg, B: int, S: int, kind: str) -> float:
    """6ND (train) / 2ND (inference) + causal attention term."""
    n = cfg.active_param_count()
    L, Hq, Dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    if kind == "decode":
        # one token against an S-long cache per layer (QK^T + PV)
        return 2.0 * n * B + 4.0 * B * Hq * S * Dh * L
    attn_fwd = 2.0 * B * Hq * float(S) * S * Dh * L  # causal half included
    if kind == "train":
        return 6.0 * n * B * S + 3.0 * attn_fwd
    return 2.0 * n * B * S + attn_fwd


def lm_config(arch_id: str, shape: LMShape, mesh: Mesh, cfg_override=None):
    """The reference's config decisions for an LM cell on ``mesh``."""
    cfg = cfg_override if cfg_override is not None else \
        get_arch(arch_id).full()
    daxes = data_axes(mesh)
    B, S = shape.global_batch, shape.seq_len
    mp = mesh.shape["model"]
    dspec = daxes[0] if len(daxes) == 1 else daxes
    dp = axis_product(mesh, daxes)
    if shape.kind in ("train", "prefill") and S % mp == 0:
        # sequence-parallel boundaries
        cfg = dataclasses.replace(cfg, act_pspec=(dspec, "model", None))
    elif shape.kind in ("train", "prefill") and cfg.d_model % mp == 0:
        cfg = dataclasses.replace(cfg, act_pspec=(dspec, None, "model"))
    # context-parallel attention when heads do not divide the model axis
    if (shape.kind in ("train", "prefill") and cfg.n_heads % mp != 0
            and S % mp == 0 and B % dp == 0):
        cfg = dataclasses.replace(cfg, cp_mesh=mesh, cp_data_axes=daxes)
    if cfg.moe is not None:
        T_l = (B // dp) * S if shape.kind in ("train", "prefill") else 0
        if shape.kind in ("train", "prefill") and T_l % mp == 0:
            # expert parallelism (all-to-all dispatch); the expert axis
            # padded up to a mesh-divisible size (Qwen2: 60 -> 64, router-
            # masked) and sequence-sharded with sequence-parallel boundaries
            e_alloc = ((cfg.moe.n_experts + mp - 1) // mp) * mp
            seq_sh = (cfg.act_pspec is not None
                      and cfg.act_pspec[1] == "model")
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(
                    cfg.moe, mesh=mesh, data_axes=daxes, model_axis="model",
                    seq_sharded=seq_sh,
                    n_experts_alloc=(e_alloc if e_alloc != cfg.moe.n_experts
                                     else 0)))
        else:
            # the reference's pjit path (tiny decode batches)
            ep = "model" if cfg.moe.e_alloc % mp == 0 else None
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(
                    cfg.moe, dispatch_pspec=(ep, dspec, None)))
    return cfg


def lm_cell(arch_id: str, shape: LMShape, shape_name: str, mesh: Mesh,
            cfg_override=None) -> LoweringCell:
    cfg = lm_config(arch_id, shape, mesh, cfg_override)
    twin_cfg = ts.with_mesh_defaults(cfg)
    daxes = data_axes(mesh)
    dp = axis_product(mesh, daxes)
    B, S = shape.global_batch, shape.seq_len
    params = tfm.init_params(None, cfg, device="meta")
    pspecs = params_shardings(params, mesh)

    if shape.kind == "train":
        ocfg = _adam_cfg(arch_id)
        state = init_train_state(params, ocfg)
        sspecs = _state_specs(state, mesh, pspecs)
        step = make_sharded_train_step(
            lambda p, b: ts.lm_loss(p, b["tokens"], b["targets"], cfg, mesh,
                                    pspecs), ocfg, mesh, pspecs, sspecs)
        twin = make_train_step(lambda p, b: tfm.lm_loss(
            p, b["tokens"], b["targets"], twin_cfg), ocfg)
        batch = {"tokens": meta((B, S), I32), "targets": meta((B, S), I32)}
        bspecs = {k: batch_sharding(mesh, 2) for k in batch}
        return LoweringCell(
            arch_id, shape_name, "train", step, (state, batch),
            (sspecs, bspecs), (sspecs, _metrics_specs()),
            model_flops_per_step=_lm_model_flops(cfg, B, S, "train"),
            cfg=cfg, twin=twin)

    if shape.kind == "prefill":
        def fn(p, t):
            if B % dp:
                raise ValueError(f"prefill over a rank mesh: batch {B} "
                                 f"does not split over {dp} data ranks")
            return ts.prefill(p, t, cfg, S, mesh, pspecs)
        cache_spec = kv_cache_shardings(mesh, cfg, B, S)
        return LoweringCell(
            arch_id, shape_name, "prefill", fn, (params, meta((B, S), I32)),
            (pspecs, batch_sharding(mesh, 2)),
            (batch_sharding(mesh, 2), cache_spec),
            model_flops_per_step=_lm_model_flops(cfg, B, S, "prefill"),
            cfg=cfg, twin=lambda p, t: tfm.prefill(p, t, twin_cfg, S))

    # decode: one token against a seq_len cache
    cache = tfm.init_kv_cache(cfg, B, S, device="meta")
    cache_spec = kv_cache_shardings(mesh, cfg, B, S)
    tok_spec = batch_sharding(mesh, 1) if B % dp == 0 else spec()
    logits_spec = batch_sharding(mesh, 2) if B % dp == 0 else spec()
    return LoweringCell(
        arch_id, shape_name, "decode",
        lambda p, t, c: ts.decode_step(p, t, c, cfg, mesh, cache_spec,
                                       pspecs),
        (params, meta((B,), I32), cache), (pspecs, tok_spec, cache_spec),
        (logits_spec, cache_spec),
        model_flops_per_step=_lm_model_flops(cfg, B, S, "decode"),
        note="split-KV sequence-sharded cache" if B == 1 else "",
        cfg=cfg, twin=lambda p, t, c: tfm.decode_step(p, t, c, twin_cfg))


# =============================================================== GNN family

def _graph_specs(shape: GNNShape, *, geometric: bool, d_feat_molecule: int,
                 pad_to: int, with_labels_dtype=I32):
    """Meta tensors of a GraphBatch at a given shape."""
    if shape.kind == "sampled":
        n, e = max_subgraph_size(shape.batch_nodes, shape.fanout)
        d_feat = 602  # reddit-style features for the sampled regime
        G = 1
    elif shape.kind == "batched":
        n = shape.n_nodes * shape.batch_graphs
        e = shape.n_edges * shape.batch_graphs
        d_feat = d_feat_molecule
        G = shape.batch_graphs
    else:
        n, e = shape.n_nodes, shape.n_edges
        d_feat = shape.d_feat
        G = 1
    N = round_up(n, pad_to)
    E = round_up(e, pad_to)
    feat = meta((N,), I32) if geometric else meta((N, d_feat), F32)
    gb = GraphBatch(
        node_feat=feat, edge_src=meta((E,), I32), edge_dst=meta((E,), I32),
        edge_mask=meta((E,), torch.bool), node_mask=meta((N,), torch.bool),
        graph_id=meta((N,), I32),
        positions=meta((N, 3), F32) if geometric else None,
        labels=meta((N,), with_labels_dtype))
    return gb, N, E, G, d_feat


def _graph_shardings(gb: GraphBatch, mesh: Mesh) -> GraphBatch:
    """Nodes and edges shard over every mesh axis (graph partitioning)."""
    axes = tuple(mesh.axis_names)

    def sh(x):
        if x is None:
            return None
        return spec(axes, *([None] * (x.dim() - 1)))
    return GraphBatch(
        node_feat=sh(gb.node_feat), edge_src=sh(gb.edge_src),
        edge_dst=sh(gb.edge_dst), edge_mask=sh(gb.edge_mask),
        node_mask=sh(gb.node_mask), graph_id=sh(gb.graph_id),
        positions=sh(gb.positions), labels=sh(gb.labels))


def _gnn_model_flops(arch_id: str, cfg, N: int, E: int, T: int = 0) -> float:
    """Analytic forward MACs*2; training multiplies by 3 (fwd + 2x bwd)."""
    if arch_id == "pna":
        h = cfg.d_hidden
        per_layer = 2 * E * 3 * h * h + 2 * N * 12 * h * h
        fwd = cfg.n_layers * per_layer + 2 * N * cfg.d_in * h \
            + 2 * N * (h * h + h * cfg.n_classes)
        return 3.0 * fwd
    if arch_id == "dimenet":
        h, nb = cfg.d_hidden, cfg.n_bilinear
        S = cfg.n_spherical * cfg.n_radial
        per_block = 2 * T * nb * h * (S + 1) + 2 * E * 6 * h * h
        fwd = cfg.n_blocks * per_block + 2 * E * 3 * h * h
        return 3.0 * fwd
    if arch_id in ("nequip", "mace"):
        from repro_torch.models.gnn.irreps import valid_paths
        M = cfg.d_hidden
        paths = valid_paths(cfg.ls, cfg.ls, cfg.ls)
        tp = sum(2 * M * (2 * a + 1) * (2 * b + 1) * (2 * c + 1)
                 for a, b, c in paths)
        dsum = sum(2 * ell + 1 for ell in cfg.ls)
        per_layer = E * tp + 2 * E * (cfg.n_rbf * 32 + 32 * len(paths) * M) \
            + 2 * N * 2 * M * M * dsum
        if arch_id == "mace":
            per_layer += (cfg.correlation_order - 1) * N * tp \
                + cfg.correlation_order * 2 * N * M * M * dsum
        fwd = cfg.n_layers * per_layer + 2 * N * M * M * dsum
        return 3.0 * fwd
    raise KeyError(arch_id)


def _pna_graph_loss(forward: Callable) -> Callable:
    def loss_fn(p, b):
        logits = forward(p, b["graph"]).to(torch.float32)
        tg = b["targets"].long()
        logz = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1, tg[:, None])[:, 0]
        return torch.mean(logz - gold)
    return loss_fn


def gnn_config(arch_id: str, shape: GNNShape, mesh: Mesh):
    """(config, graph meta batch, N, E, G, triplet cap) as the reference's
    cell decides them."""
    pad = max(mesh.size, 512)
    if arch_id == "pna":
        gb, N, E, G, d_feat = _graph_specs(shape, geometric=False,
                                           d_feat_molecule=16, pad_to=pad)
        # bf16 hidden state on huge graphs (the reference's choice)
        dt = torch.bfloat16 if E > 10_000_000 else torch.float32
        cfg = pn.PNAConfig(name="pna", n_layers=4, d_hidden=75, d_in=d_feat,
                           n_classes=47, avg_degree=max(E / max(N, 1), 1.0),
                           graph_level=shape.kind == "batched", n_graphs=G,
                           dtype=dt, mesh=mesh,
                           shard_axes=tuple(mesh.axis_names))
        return cfg, gb, N, E, G, 0
    gb, N, E, G, _ = _graph_specs(shape, geometric=True, d_feat_molecule=0,
                                  pad_to=pad)
    if arch_id == "dimenet":
        # triplet capacity: molecule graphs are dense (8x), huge graphs
        # use a sampled 2x cap
        t_cap = round_up(E * (8 if E < 10_000_000 else 2), pad)
        cfg = dn.DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                               n_bilinear=8, n_spherical=7, n_radial=6,
                               cutoff=5.0, n_types=64, graph_level=True,
                               n_graphs=G)
        return cfg, gb, N, E, G, t_cap
    if arch_id == "nequip":
        cfg = nq.NequIPConfig(name="nequip", n_layers=5, d_hidden=32,
                              l_max=2, n_rbf=8, cutoff=5.0, n_types=64,
                              n_graphs=G)
        return cfg, gb, N, E, G, 0
    if arch_id == "mace":
        cfg = mc.MACEConfig(name="mace", n_layers=2, d_hidden=128, l_max=2,
                            correlation_order=3, n_rbf=8, cutoff=5.0,
                            n_types=64, n_graphs=G)
        return cfg, gb, N, E, G, 0
    raise KeyError(arch_id)


_GNN_MODULES = {"pna": pn, "dimenet": dn, "nequip": nq, "mace": mc}


def gnn_cell(arch_id: str, shape: GNNShape, shape_name: str, mesh: Mesh,
             cfg_override: Optional[dict] = None) -> LoweringCell:
    """``cfg_override``: config fields replaced after the reference's
    decisions (smaller widths for a run on the CPU)."""
    cfg, gb, N, E, G, t_cap = gnn_config(arch_id, shape, mesh)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    mod = _GNN_MODULES[arch_id]
    ocfg = opt.AdamWConfig()
    axes = tuple(mesh.axis_names)
    part = RowPartition(mesh, axes)
    extra = {}
    if arch_id == "pna":
        twin_cfg = dataclasses.replace(cfg, mesh=None, shard_axes=())
        if cfg.graph_level:
            loss_fn = _pna_graph_loss(lambda p, g: pn.forward(p, g, cfg))
            twin_loss = _pna_graph_loss(lambda p, g: pn.forward(p, g,
                                                                twin_cfg))
            targets = meta((G,), I32)
        else:
            loss_fn = lambda p, b: pn.loss_fn(p, b["graph"], cfg)
            twin_loss = lambda p, b: pn.loss_fn(p, b["graph"], twin_cfg)
            targets = meta((1,), I32)   # labels live in the GraphBatch
    else:
        targets = meta((G,), F32)
        if arch_id == "dimenet":
            extra = {"triplets": (meta((t_cap,), I32), meta((t_cap,), I32),
                                  meta((t_cap,), torch.bool))}

            def loss_of(gb_of):
                return lambda p, b: dn.energy_loss(
                    p, gb_of(b["graph"]), cfg, b["triplets"], b["targets"])
        else:
            def loss_of(gb_of):
                return lambda p, b: mod.energy_loss(p, gb_of(b["graph"]),
                                                    cfg, b["targets"])
        loss_fn = loss_of(lambda g: partitioned(g, part))
        twin_loss = loss_of(lambda g: g)
    params = mod.init_params(None, cfg, device="meta")
    state = init_train_state(params, ocfg)
    pspecs = _replicated_like(params)
    sspecs = TrainState(params=pspecs, opt_state=opt.AdamState(
        step=spec(), m=_replicated_like(state.opt_state.m),
        v=_replicated_like(state.opt_state.v)), ef=None)
    batch = {"graph": gb, "targets": targets, **extra}
    bspecs = {"graph": _graph_shardings(gb, mesh), "targets": spec()}
    if extra:
        bspecs["triplets"] = (spec(axes),) * 3
    step = make_sharded_train_step(loss_fn, ocfg, mesh, pspecs, sspecs)
    flops = _gnn_model_flops(arch_id, cfg, N, E, t_cap)
    return LoweringCell(arch_id, shape_name, "train", step, (state, batch),
                        (sspecs, bspecs), (sspecs, _metrics_specs()),
                        model_flops_per_step=flops, cfg=cfg,
                        twin=make_train_step(twin_loss, ocfg))


# ============================================================ recsys family

def recsys_cell(arch_id: str, shape: RecsysShape, shape_name: str, mesh: Mesh,
                cfg_override=None) -> LoweringCell:
    cfg = cfg_override if cfg_override is not None else \
        get_arch(arch_id).full()
    daxes = data_axes(mesh)
    dsize = axis_product(mesh, daxes)
    params = mi.init_params(None, cfg, device="meta")
    pspecs = params_shardings(params, mesh)
    L = cfg.hist_len

    def whole(p):
        """Every parameter gathered at use."""
        return _map2(lambda x, sp: gather_full(x, sp, mesh), p, pspecs)

    if shape.kind == "train":
        B = shape.batch
        cfg = dataclasses.replace(
            cfg, logits_pspec=(daxes[0] if len(daxes) == 1 else daxes, None))
        twin_cfg = dataclasses.replace(cfg, logits_pspec=None)
        ocfg = opt.AdamWConfig()
        state = init_train_state(params, ocfg)
        sspecs = _state_specs(state, mesh, pspecs)
        batch = {"hist": meta((B, L), I32), "hist_mask": meta((B, L),
                                                             torch.bool),
                 "target": meta((B,), I32)}
        bspecs = {"hist": batch_sharding(mesh, 2),
                  "hist_mask": batch_sharding(mesh, 2),
                  "target": batch_sharding(mesh, 1)}
        step = make_sharded_train_step(
            lambda p, b: mi.train_loss(whole(p), b, cfg, mesh), ocfg, mesh,
            pspecs, sspecs)
        return LoweringCell(arch_id, shape_name, "train", step,
                            (state, batch), (sspecs, bspecs),
                            (sspecs, _metrics_specs()),
                            model_flops_per_step=6.0 * B * (
                                L * cfg.embed_dim ** 2 + B * cfg.embed_dim),
                            cfg=cfg, twin=make_train_step(
                                lambda p, b: mi.train_loss(p, b, twin_cfg),
                                ocfg))

    if shape.kind == "serve":
        B, C = shape.batch, shape.n_candidates
        args = (params, meta((B, L), I32), meta((B, L), torch.bool),
                meta((B, C), I32))
        in_sp = (pspecs, batch_sharding(mesh, 2), batch_sharding(mesh, 2),
                 batch_sharding(mesh, 2))
        return LoweringCell(
            arch_id, shape_name, "serve",
            lambda p, h, m, c: mi.score_candidates(whole(p), h, m, c, cfg),
            args, in_sp, batch_sharding(mesh, 2),
            model_flops_per_step=2.0 * B * (
                L * cfg.embed_dim ** 2 + C * cfg.n_interests * cfg.embed_dim),
            cfg=cfg,
            twin=lambda p, h, m, c: mi.score_candidates(p, h, m, c, cfg))

    # retrieval: 1 user x n_candidates, the candidates over the data axes
    C = shape.n_candidates
    Cpad = round_up(C, dsize)
    args = (params, meta((1, L), I32), meta((1, L), torch.bool),
            meta((Cpad,), I32))
    cand = spec(daxes)
    return LoweringCell(
        arch_id, shape_name, "retrieval",
        lambda p, h, m, c: mi.retrieval_scores(whole(p), h, m, cfg, c),
        args, (pspecs, spec(), spec(), cand), cand,
        model_flops_per_step=2.0 * C * cfg.n_interests * cfg.embed_dim,
        cfg=cfg,
        twin=lambda p, h, m, c: mi.retrieval_scores(p, h, m, cfg, c))


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not (
            isinstance(tree, tuple) and hasattr(tree, "_fields")):
        return type(tree)(_map2(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


# ==================================================================== entry

def build_cell(arch_id: str, shape_name: str, mesh: Mesh) -> LoweringCell:
    spec_ = get_arch(arch_id)
    if spec_.family == "lm":
        return lm_cell(arch_id, LM_SHAPES[shape_name], shape_name, mesh)
    if spec_.family == "gnn":
        return gnn_cell(arch_id, GNN_SHAPES[shape_name], shape_name, mesh)
    return recsys_cell(arch_id, RECSYS_SHAPES[shape_name], shape_name, mesh)


def calibration_cells(arch_id: str, shape_name: str, mesh: Mesh,
                      layers=(2, 4)):
    """Small LM variants (L = 2 and 4, ``unroll_scans`` set as the
    reference sets it) for per-layer cost extrapolation:
      est(L) = c2 + (L - 2) / 2 * (c4 - c2).
    The port's counts cover every layer already; the roofline's tests
    hold the extrapolation to the direct count."""
    spec_ = get_arch(arch_id)
    if spec_.family != "lm":
        return None  # GNN/recsys models unroll naturally (python loops)
    out = []
    for L in layers:
        small = dataclasses.replace(spec_.full(), n_layers=L,
                                    unroll_scans=True)
        out.append(lm_cell(arch_id, LM_SHAPES[shape_name], shape_name, mesh,
                           cfg_override=small))
    return out


# ================================================================== inputs

def tree_paths(tree, path: str = ""):
    """(key path, leaf) pairs in the reference's ``keystr`` spelling (a
    dict key ``['k']``, an index ``[i]``, a NamedTuple or dataclass field
    ``.name``); None leaves are skipped, as JAX's flattening skips them.
    Leaves are tensors or spec tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{path}['{k}']")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from tree_paths(v, f"{path}.{k}")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tree_paths(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, list) or (isinstance(tree, tuple) and tree and
                                    not _is_spec(tree)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _is_spec(t) -> bool:
    return isinstance(t, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in t)


def map_tree(fn, tree, *others):
    """``fn(leaf, *leaves of others at the same path)`` for each tensor of
    ``tree`` (dicts, lists, tuples, NamedTuples, GraphBatch); the others
    may hold spec tuples where ``tree`` holds tensors."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v, *(o[i] for o in others))
                            for i, v in enumerate(tree)))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tree(fn, getattr(tree, f.name),
                             *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *others)


def local_inputs(cell: LoweringCell, args, mesh: Mesh):
    """This rank's blocks of ``args`` (global tensors, or the cell's meta
    ``args``) under the cell's ``in_specs``."""
    return map_tree(lambda x, sp: local_block(x, sp, mesh).contiguous(),
                    args, cell.in_specs)


def _init_params(cell: LoweringCell, gen, device):
    family = get_arch(cell.arch_id).family
    if family == "lm":
        return tfm.init_params(gen, cell.cfg, device=device)
    if family == "gnn":
        return _GNN_MODULES[cell.arch_id].init_params(gen, cell.cfg,
                                                      device=device)
    return mi.init_params(gen, cell.cfg, device=device)


def _graph(arg: GraphBatch, rng: np.random.Generator, cell: LoweringCell,
           mesh: Mesh, device):
    """A random graph in the layout of ``arg`` (meta): real nodes and
    edges first in every rank's node block, padding masked.  PNA's edges
    go to the block of the rank that owns their destination, as its
    dst-partitioned layer takes them."""
    N, E = arg.node_feat.shape[0], arg.edge_src.shape[0]
    n_ranks = mesh.size
    n_loc, e_loc = N // n_ranks, E // n_ranks
    nr, er = max(1, n_loc * 3 // 4), max(1, e_loc * 3 // 4)
    node_mask = np.zeros(N, bool)
    src = np.zeros(E, np.int32)
    dst = np.zeros(E, np.int32)
    emask = np.zeros(E, bool)
    real = np.concatenate([np.arange(r * n_loc, r * n_loc + nr)
                           for r in range(n_ranks)])
    node_mask[real] = True
    for r in range(n_ranks):
        sl = slice(r * e_loc, r * e_loc + er)
        src[sl] = rng.choice(real, er)
        dst[sl] = (rng.integers(r * n_loc, r * n_loc + nr, er)
                   if cell.arch_id == "pna" else rng.choice(real, er))
        emask[sl] = True
    G = getattr(cell.cfg, "n_graphs", 1)
    gid = np.zeros(N, np.int32)
    gid[real] = np.sort(rng.integers(0, G, real.size)).astype(np.int32)
    dev = resolve_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    if arg.positions is not None:
        feat = t(rng.integers(0, cell.cfg.n_types, N).astype(np.int32))
        pos = t(rng.normal(size=(N, 3)).astype(np.float32) * 2.0)
    else:
        feat = t(rng.normal(size=tuple(arg.node_feat.shape)).astype(
            np.float32))
        pos = None
    n_cls = getattr(cell.cfg, "n_classes", 1)
    return GraphBatch(
        node_feat=feat, edge_src=t(src), edge_dst=t(dst), edge_mask=t(emask),
        node_mask=t(node_mask), graph_id=t(gid), positions=pos,
        labels=t(rng.integers(0, n_cls, N).astype(np.int32))), (src, dst,
                                                               emask)


def rank_inputs(cell: LoweringCell, mesh: Mesh, seed: int = 0,
                device: DeviceLike = None):
    """This rank's blocks of :func:`global_inputs` (``mesh`` a rank mesh),
    made without the whole optimizer state: the parameters are drawn whole
    and cut, the moments are zeros of the rank's block shapes (what the
    whole state's zeros give, 8-bit codes and scales included)."""
    if cell.kind != "train":
        return local_inputs(cell, global_inputs(cell, mesh, seed, device),
                            mesh)
    dev = resolve_device(device)
    params = _init_params(cell, torch.Generator(device=dev).manual_seed(seed),
                          dev)
    st_specs, b_specs = cell.in_specs
    params = map_tree(lambda x, sp: local_block(x, sp, mesh).clone(), params,
                      st_specs.params)
    zeros = map_tree(lambda x, sp: torch.zeros(
        local_block(x, sp, mesh).shape, dtype=x.dtype, device=dev),
        cell.args[0].opt_state, st_specs.opt_state)
    batch = _batch(cell, mesh, np.random.default_rng(seed), dev)
    return (TrainState(params, zeros, None),
            map_tree(lambda x, sp: local_block(x, sp, mesh).contiguous(),
                     batch, b_specs))


def global_inputs(cell: LoweringCell, mesh: Mesh, seed: int = 0,
                  device: DeviceLike = None):
    """A cell's global inputs, drawn from ``seed``: parameters by the
    model's initialiser (a generator on ``device``), ids and graphs with
    numpy; optimizer moments zero."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    params = _init_params(cell, gen, dev)
    cfg = cell.cfg

    def ints(hi, shape):
        return torch.as_tensor(rng.integers(0, hi, shape).astype(np.int32),
                               device=dev)
    kind = cell.kind
    family = get_arch(cell.arch_id).family
    if kind == "train":
        state = init_train_state(params, _adam_cfg(cell.arch_id)
                                 if family == "lm" else opt.AdamWConfig())
        return state, _batch(cell, mesh, rng, dev)
    if kind == "prefill":
        return params, ints(cfg.vocab, tuple(cell.args[1].shape))
    if kind == "decode":
        cache_m = cell.args[2]
        Lc, B, H, S, Dh = cache_m["k"].shape
        filled = rng.integers(S // 2, S, B)           # positions held
        k = torch.randn((Lc, B, H, S, Dh), generator=gen, device=dev,
                        dtype=cfg.dtype)
        v = torch.randn((Lc, B, H, S, Dh), generator=gen, device=dev,
                        dtype=cfg.dtype)
        live = (torch.arange(S, device=dev)[None, :]
                < torch.as_tensor(filled, device=dev)[:, None])
        live = live[None, :, None, :, None].to(cfg.dtype)
        cache = {"k": k * live, "v": v * live,
                 "len": torch.as_tensor(filled.astype(np.int32), device=dev)}
        return params, ints(cfg.vocab, (B,)), cache
    # serve / retrieval
    h = cell.args[1]
    B, L = h.shape
    mask = rng.random((B, L)) < 0.8
    mask[:, 0] = True
    cand = ints(cfg.n_items, tuple(cell.args[3].shape))
    return (params, ints(cfg.n_items, (B, L)),
            torch.as_tensor(mask, device=dev), cand)


def _batch(cell: LoweringCell, mesh: Mesh, rng: np.random.Generator, dev):
    """A train cell's global batch, drawn with ``rng`` (after the
    parameters, whose draw does not touch it)."""
    cfg = cell.cfg
    family = get_arch(cell.arch_id).family
    b = cell.args[1]

    def ints(hi, shape):
        return torch.as_tensor(rng.integers(0, hi, shape).astype(np.int32),
                               device=dev)
    if family == "lm":
        return {k: ints(cfg.vocab, tuple(v.shape)) for k, v in b.items()}
    if family == "recsys":
        B, L = b["hist"].shape
        mask = rng.random((B, L)) < 0.8
        mask[:, 0] = True
        return {"hist": ints(cfg.n_items, (B, L)),
                "hist_mask": torch.as_tensor(mask, device=dev),
                "target": ints(cfg.n_items, (B,))}
    gb, (src, dst, emask) = _graph(b["graph"], rng, cell, mesh, dev)
    G = b["targets"].shape[0]
    if cell.arch_id == "pna":
        tg = ints(cfg.n_classes, (G,)) if cfg.graph_level else ints(1, (1,))
    else:
        tg = torch.as_tensor(rng.normal(size=G).astype(np.float32),
                             device=dev)
    batch = {"graph": gb, "targets": tg}
    if "triplets" in b:
        cap = b["triplets"][0].shape[0]
        real = np.nonzero(emask)[0]
        t_in, t_out, t_mask = build_triplets(src[real], dst[real],
                                             max_triplets=cap)
        batch["triplets"] = (
            torch.as_tensor(real[t_in].astype(np.int32), device=dev),
            torch.as_tensor(real[t_out].astype(np.int32), device=dev),
            torch.as_tensor(t_mask, device=dev))
    return batch

"""The cells' per-rank programs on 8 gloo CPU ranks (a 2 x 4 data x model
mesh) against the port's single-process step on the same inputs.

One spawn runs every case: each rank builds the cell with
``launch/steps.py``'s cell functions at a family's smoke config, makes its
blocks of the seeded inputs (``rank_inputs``) and runs ``cell.fn``; the
parent runs ``cell.twin`` on the whole inputs (``global_inputs``) and
holds every rank's result blocks (outputs, loss, gradient norm, updated
parameters and moments, caches) to the twin's blocks at rtol = atol =
2e-4, and each block of the first moment (0.1 x the gradient) to 2e-4 of
its leaf's largest magnitude.  The single-process steps are held to the
reference by the other ``test_torch_*`` files.  Rank 0 also runs each cell on a meta mesh
(``make_meta_mesh``) on meta tensors: the collective calls and bytes it
counts there must equal what it counted on gloo, which ties the dry run's
counts to real runs.

The MoE training cells run with ``router_aux_weight = 0``: the
expert-parallel layer's aux loss is the mean of every peer's (the
reference's sharded definition), not the single-device layer's, and the
smoke capacity factor drops nothing on either side.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.shapes import GNNShape, LMShape, RecsysShape
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import make_meta_mesh, make_rank_mesh
from repro_torch.launch.sharding import local_block
from repro_torch.launch.spawn import spawn

SHAPE, AXES = (2, 4), ("data", "model")
SEED = 3
TOL = 2e-4


def _lm(arch, kind, S, B, **cfg):
    base = get_arch(arch).smoke()
    if base.moe is not None and kind == "train":
        cfg.setdefault("moe", dataclasses.replace(base.moe,
                                                  router_aux_weight=0.0))
    return lambda mesh: St.lm_cell(arch, LMShape(kind, S, B), kind, mesh,
                                   dataclasses.replace(base, **cfg))


def _gnn(arch, shape, **cfg):
    return lambda mesh: St.gnn_cell(arch, shape, arch, mesh, cfg)


def _mind(shape):
    return lambda mesh: St.recsys_cell("mind", shape, shape.kind, mesh,
                                       get_arch("mind").smoke())


MOLECULE = GNNShape("batched", 6, 10, batch_graphs=4)
CASES = {
    # sequence-parallel boundaries, TP attention, expert parallelism
    # (6 experts padded to 8), vocab-parallel loss, ZeRO gathers
    "train_tp_sp_qwen2_moe": _lm("qwen2-moe-a2.7b", "train", 16, 4),
    # 8 query heads over 2 KV heads on 4 model ranks: each rank's query
    # heads read a KV head split over two ranks' wk/wv columns (gathered);
    # 8-bit AdamW moments, some whole where their parameter is split
    "train_tp_gqa_qwen3_moe": _lm("qwen3-moe-235b-a22b", "train", 16, 4),
    # 6 heads over 4 model ranks: context-parallel attention, remat on
    "train_cp_starcoder2": _lm("starcoder2-3b", "train", 16, 4, remat=True),
    # S = 6 does not split over 4: d_model-sharded boundaries (MQA, GeGLU)
    "train_dmodel_gemma": _lm("gemma-2b", "train", 6, 4),
    "prefill_tp_qwen2_moe": _lm("qwen2-moe-a2.7b", "prefill", 16, 4),
    "prefill_cp_starcoder2": _lm("starcoder2-3b", "prefill", 16, 4),
    # batch over data, sequence over model; tensor-parallel experts (6
    # over 4, dispatch_pspec ep = None), the single device's drops
    "decode_qwen2_moe": _lm("qwen2-moe-a2.7b", "decode", 32, 4),
    "decode_starcoder2": _lm("starcoder2-3b", "decode", 32, 4),
    # B = 1: the sequence over every axis; experts over model (ep)
    "decode_b1_qwen3_moe": _lm("qwen3-moe-235b-a22b", "decode", 32, 1),
    "pna_full": _gnn("pna", GNNShape("full", 200, 600, d_feat=8),
                     d_hidden=16, n_classes=4),
    "pna_molecule": _gnn("pna", MOLECULE, d_hidden=16, n_classes=4),
    "dimenet": _gnn("dimenet", MOLECULE, d_hidden=24, n_bilinear=4,
                    n_spherical=3, n_radial=3, n_types=8),
    "nequip": _gnn("nequip", MOLECULE, d_hidden=8, n_types=8),
    "mace": _gnn("mace", MOLECULE, d_hidden=8, n_types=8),
    "mind_train": _mind(RecsysShape("train", 16)),
    "mind_serve": _mind(RecsysShape("serve", 16, n_candidates=5)),
    "mind_retrieval": _mind(RecsysShape("retrieval", 1, n_candidates=50)),
}


def _numpy_leaves(tree):
    return {p: x.detach().to(torch.float32).numpy()
            if x.is_floating_point() else x.detach().numpy()
            for p, x in St.tree_paths(tree)}


def _counts(mesh):
    return {k: dict(v) for k, v in mesh.counts.items() if k != "staged"}


def rank_program(rank, world_size, init_method):
    mesh = make_rank_mesh(world_size, rank, init_method, SHAPE, AXES,
                          backend="gloo", devices="cpu")
    out = {}
    for name, build in CASES.items():
        cell = build(mesh)
        args = St.rank_inputs(cell, mesh, seed=SEED, device="cpu")
        mesh.reset_counts()
        res = cell.fn(*args)
        rec = {"leaves": _numpy_leaves(res), "counts": _counts(mesh)}
        if rank == 0:
            mm = make_meta_mesh(SHAPE, AXES, rank=0)
            mcell = build(mm)
            mcell.fn(*St.local_inputs(mcell, mcell.args, mm))
            rec["meta_counts"] = _counts(mm)
        out[name] = rec
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn(rank_program, SHAPE[0] * SHAPE[1], timeout=240)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_blocks_equal_single_process_step(ranks, name):
    build = CASES[name]
    shape_mesh = make_meta_mesh(SHAPE, AXES, rank=0)
    cell = build(shape_mesh)
    args = St.global_inputs(cell, shape_mesh, seed=SEED, device="cpu")
    want_full = cell.twin(*args)
    for rank, got in enumerate(ranks):
        rm = make_meta_mesh(SHAPE, AXES, rank=rank)
        want = _numpy_leaves(St.map_tree(
            lambda t, sp: local_block(t, sp, rm), want_full, cell.out_specs))
        leaves = got[name]["leaves"]
        assert set(leaves) == set(want), (name, rank)
        for path, w in want.items():
            g = leaves[path]
            assert g.shape == w.shape, (name, rank, path)
            if path.endswith("['q']"):
                # an 8-bit code: a moment that rounds another way at a .5
                # tie lands one code over (as the optimizer's tests allow)
                diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert diff.max() <= 1, (name, rank, path)
                continue
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} rank {rank} {path}")
            if ".opt_state.m" in path and w.size:
                # the first moment is 0.1 x the gradient: held to its
                # leaf's scale, where the absolute tolerance would hide it
                err = np.abs(g.astype(np.float64) - w).max()
                assert err <= TOL * np.abs(w).max(), (name, rank, path, err)


@pytest.mark.parametrize("name", list(CASES))
def test_meta_mesh_counts_equal_gloo(ranks, name):
    rec = ranks[0][name]
    assert rec["counts"], name
    assert rec["meta_counts"] == rec["counts"], name

"""The dry run and its H100 roofline (``launch/dryrun.py``,
``roofline/``), on the CPU with meta tensors.

* The meta FLOP count of an LM train cell on a 1 x 1 mesh equals the
  analytic sum of its matmul FLOPs: the forward, twice each in the
  backward pass, remat's recomputed layer forward and the chunk recompute
  of chunked attention (each up to checkpoint's early stop).
* Counts at L = 2, 4 and 6 are linear: ``extrapolate`` from L = 2 and 4
  gives L = 6's count, as the reference's ``extrapolate`` does on the same
  tuples.
* On a 2 x 4 meta mesh, eight times rank 0's FLOPs stays within 1 % of
  the 1 x 1 count (the same work, split; context-parallel attention reads
  every key for its queries).
* ``report_md.render`` gives the reference's text for the same rows.
* ``run_cell`` runs one cell of each family on 16 x 16 with the
  H100's constants only.
"""
from __future__ import annotations

import dataclasses

import pytest

from repro.roofline import analysis as r_analysis
from repro.roofline import report_md as r_report_md
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import LMShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_meta_mesh
from repro_torch.launch.steps import lm_cell
from repro_torch.roofline import analysis as A
from repro_torch.roofline import report_md

B, S = 4, 16


def _cfg(layers=2):
    return dataclasses.replace(get_arch("starcoder2-3b").smoke(),
                               n_layers=layers, remat=True, attn_chunk=8)


def _count(cfg, shape=(1, 1)):
    mesh = make_meta_mesh(shape)
    cell = lm_cell("starcoder2-3b", LMShape("train", S, B), "t", mesh, cfg)
    return A.raw_counts(cell, mesh), mesh


def test_train_flops_equal_analytic_matmul_sum():
    cfg = _cfg()
    (flops, _, _), _ = _count(cfg)
    T, D, F, V = B * S, cfg.d_model, cfg.d_ff, cfg.vocab
    proj = 2 * T * D * (cfg.q_dim + 2 * cfg.kv_dim) + 2 * T * cfg.q_dim * D
    ffn_one = 2 * T * D * F                  # one of the GLU's 3 matmuls
    half = 2 * B * cfg.n_heads * S * S * cfg.head_dim   # QK^T, or PV
    head = 2 * T * D * V
    # each matmul: forward + 2x backward.  Remat recomputes a layer's
    # forward, but a recompute stops once it holds every tensor the
    # backward saved (checkpoint's early stop): the FFN's last matmul
    # (wo) is not recomputed; chunked attention recomputes each chunk's
    # logits (QK^T) once more in the chunk's backward, not its PV product
    per_layer = (3 * proj + 3 * 3 * ffn_one + 3 * 2 * half      # fwd + bwd
                 + proj + 2 * ffn_one + 2 * half                # remat
                 + half)                                        # chunks
    assert flops == 3 * head + cfg.n_layers * per_layer


def test_counts_linear_in_layers_and_extrapolation_matches_reference():
    ref = r_analysis
    c = {L: _count(_cfg(L))[0] for L in (2, 4, 6)}
    assert c[6][0] - c[4][0] == c[4][0] - c[2][0] > 0
    assert c[6][1] - c[4][1] == c[4][1] - c[2][1] > 0
    got = A.extrapolate(c[2], c[4], 2, 4, 6)
    assert got == ref.extrapolate(c[2], c[4], 2, 4, 6)
    assert got[0] == c[6][0] and got[1] == c[6][1]
    assert got[2] == pytest.approx(c[6][2])


def test_sharded_flops_sum_to_single_rank_count():
    cfg = _cfg()
    (one, _, coll1), _ = _count(cfg)
    (rank0, _, coll8), mesh = _count(cfg, (2, 4))
    ratio = mesh.size * rank0 / one
    assert 0.99 <= ratio <= 1.01, ratio
    assert sum(coll8.values()) > 0


def test_report_md_renders_as_the_reference():
    ref = r_report_md
    rows = [dryrun.run_cell("mind", "serve_p99", verbose=False),
            {"arch": "x", "shape": "y", "kind": "train", "compute_s": 1.5e-3,
             "memory_s": 2.0e-2, "collective_s": 3e-4, "dominant": "memory",
             "useful_ratio": 0.5, "roofline_fraction": 0.0123,
             "peak_memory_bytes": 2.5e12, "multi_pod": False,
             "status": "ok"},
            {"arch": "z", "shape": "w", "multi_pod": True, "status": "FAIL"}]
    for mp in (False, True):
        assert report_md.render(rows, mp) == ref.render(rows, mp)
    for b in (3e12, 4e9, 5e6):
        assert report_md.fmt_bytes(b) == ref.fmt_bytes(b)


@pytest.mark.parametrize("arch,shape", [("gemma-2b", "decode_32k"),
                                        ("nequip", "molecule"),
                                        ("mind", "serve_p99")])
def test_run_cell_each_family(arch, shape):
    ref = r_analysis
    row = dryrun.run_cell(arch, shape, verbose=False)
    assert row["status"] == "ok" and row["chips"] == 256
    keys = set(ref.RooflineReport("a", "s", 1, 1.0, 1.0, 1.0, {}, 1.0).row())
    assert keys <= set(row)
    assert row["hlo_flops"] > 0 and row["hlo_bytes"] > 0
    assert row["coll_breakdown"] and row["peak_memory_bytes"] > 0
    assert A.HW["peak_flops_bf16"] == 989e12
    assert A.HW["hbm_bw"] == 3.35e12
    assert ref.HW["peak_flops_bf16"] not in A.HW.values()
    assert ref.HW["hbm_bw"] not in A.HW.values()
    mesh = make_meta_mesh((16, 16))
    # a 16-rank model axis spans two 8-card nodes; a 2 x 2 mesh one
    assert A.link_bw(mesh, "model") == A.HW["network_bw"]
    assert A.link_bw(make_meta_mesh((2, 2)), "data") == A.HW["nvlink_bw"]

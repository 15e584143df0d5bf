"""The port's PNA == the reference's, on the CPU.

Graphs are drawn with numpy from a seed and padded by each package's
``pad_graph`` (padded edges and nodes, nodes with no in-edge); weights are
the reference's, carried by ``interop.pna_params_from_arrays``; the
reference runs under ``jax.jit`` (config static).  Tolerances, fp32:
max and min bit for bit, everything else rtol 1e-4 with an atol of 1e-5
of the tensor's largest magnitude (at least 1e-5); gradients rtol 1e-4
with an atol of 1e-4.  The std of a node of in-degree one has a zero
derivative in exact arithmetic: each package computes it as the rounding
residue of its ``meansq - mean²`` backward, times 1/(2·sqrt(1e-5)) ≈ 158,
so the gradients carry different noise of order 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as r_configs
from repro.models.gnn import graphdata as r_gd
from repro.models.gnn import pna as r_pna
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.models.common import tree_leaves
from repro_torch.models.gnn import graphdata as p_gd
from repro_torch.models.gnn import pna as p_pna

R_TRAIN = jax.jit(lambda p, gb, cfg: (r_pna.forward(p, gb, cfg),
                                      jax.value_and_grad(r_pna.loss_fn)(
                                          p, gb, cfg)), static_argnums=2)


def close(got, want, what="", rtol=1e-4, atol=1e-5):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want)
    atol = atol * max(float(np.abs(w).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def graph(n, e, d_in, n_classes, seed=0, isolated=3):
    """Host arrays of a random graph whose last ``isolated`` nodes have no
    in-edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - isolated, e)
    feat = rng.standard_normal((n, d_in)).astype(np.float32)
    labels = rng.integers(0, n_classes, n)
    return feat, src, dst, labels


def batches(feat, src, dst, labels, node_pad=16, edge_pad=64, **kw):
    args = dict(labels=labels, node_pad=node_pad, edge_pad=edge_pad, **kw)
    return (r_gd.pad_graph(feat, src, dst, **args),
            p_gd.pad_graph(feat, src, dst, device="cpu", **args))


def port_cfg(rcfg):
    kw = {f.name: getattr(rcfg, f.name)
          for f in dataclasses.fields(p_pna.PNAConfig) if f.name != "dtype"}
    return p_pna.PNAConfig(**kw)


def pair(rcfg, seed=1):
    pr = r_pna.init_params(jax.random.PRNGKey(seed), rcfg)
    arr = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), pr)
    return pr, interop.pna_params_from_arrays(arr, device="cpu")


# --------------------------------------------------------------- aggregate

@pytest.mark.parametrize("D", [1, 16, 75])
def test_aggregate_padded_edges_and_empty_rows(D):
    """Padded edges (mask false, some aimed at rows that have no valid
    edge) count in no denominator; empty rows give 0 for max, min and std
    and the mean of nothing.  Against the compiled reference, whose
    ``meansq - mean²`` is one fused multiply-add: at a row of one edge that
    residual is the whole variance."""
    rng = np.random.default_rng(D)
    n, e = 12, 50
    dst = rng.integers(0, n - 3, e)              # rows 9-11: no edges
    mask = rng.random(e) < 0.8
    dst[:4], mask[:4] = 9, False                 # row 9: only padded edges
    msg = rng.standard_normal((e, D)).astype(np.float32)
    want, want_deg = jax.jit(r_pna._aggregate, static_argnums=3)(
        jnp.asarray(msg), jnp.asarray(dst), jnp.asarray(mask), n)
    got, deg = p_pna._aggregate(torch.from_numpy(msg), torch.from_numpy(dst),
                                torch.from_numpy(mask), n)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(want_deg))
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(got[:, D:3 * D], want[:, D:3 * D])
    close(got, want, "mean | max | min | std")
    assert deg[9] == 0 and not got[9:].any()


def test_aggregate_equals_segment_multi_agg_plain():
    """The same four aggregates as the kernel's plain version over the
    bucketed messages, within the kernel's fp32 tolerance (1e-5): the
    comparison the smoke makes on the card at SNB ×10."""
    rng = np.random.default_rng(5)
    n, e, D = 40, 300, 75
    dst = torch.from_numpy(rng.integers(0, n - 4, e))
    msg = torch.from_numpy(rng.standard_normal((e, D)).astype(np.float32))
    agg, _ = p_pna._aggregate(msg, dst, torch.ones(e, dtype=torch.bool), n)
    outs = ref.segment_multi_agg_ref(*ops.bucketize_messages(dst, msg, n))
    for name, got, want in zip(("mean", "max", "min", "std"),
                               agg.split(D, dim=1), outs):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   msg=name)


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("which,n,e", [("smoke", 40, 150),
                                       ("full", 60, 240)])
def test_pna_forward_loss_and_gradient(which, n, e):
    """At the smoke config, and at full width (4 layers, d_hidden 75, d_in
    1,433, 47 classes) on a small graph."""
    rcfg = getattr(r_configs.get_arch("pna"), which)()
    pcfg = getattr(get_arch("pna"), which)()
    assert pcfg == port_cfg(rcfg)
    feat, src, dst, labels = graph(n, e, rcfg.d_in, rcfg.n_classes)
    gr, gp = batches(feat, src, dst, labels)
    assert int(gp.edge_mask.sum()) == e < gp.n_edges    # padded edges
    pr, pt = pair(rcfg)
    logits_r, (loss_r, grads_r) = R_TRAIN(pr, gr, rcfg)
    close(p_pna.forward(pt, gp, pcfg), logits_r, "logits")
    leaves = tree_leaves(pt)
    for t in leaves:
        t.requires_grad_(True)
    loss = p_pna.loss_fn(pt, gp, pcfg)
    close(loss, loss_r, "loss", rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree_util.tree_leaves(grads_r)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        close(g, w, "gradient", atol=1e-4)


def test_pna_graph_level_readout():
    rcfg = dataclasses.replace(r_configs.get_arch("pna").smoke(),
                               graph_level=True, n_graphs=3)
    pcfg = port_cfg(rcfg)
    feat, src, dst, labels = graph(30, 90, rcfg.d_in, rcfg.n_classes, 2)
    gid = np.repeat(np.arange(3), 10)
    gr, gp = batches(feat, src, dst, labels, graph_id=gid)
    pr, pt = pair(rcfg, 3)
    want = jax.jit(r_pna.forward, static_argnums=2)(pr, gr, rcfg)
    got = p_pna.forward(pt, gp, pcfg)
    assert tuple(got.shape) == (3, rcfg.n_classes)
    close(got, want, "pooled logits")


def test_pna_mesh_raises():
    """The sharded layer runs on a rank mesh (tests/test_torch_multidevice
    holds it to the reference); any other mesh object is refused."""
    cfg = dataclasses.replace(get_arch("pna").smoke(), mesh=object())
    gb = p_gd.random_graph_batch(torch.Generator().manual_seed(0), 8, 20,
                                 cfg.d_in, device="cpu")
    params = p_pna.init_params(torch.Generator().manual_seed(1), cfg,
                               device="cpu")
    with pytest.raises(TypeError, match="rank mesh"):
        p_pna.forward(params, gb, cfg)


def test_pna_smoke_on_random_graph_batch():
    """The reference's PNA smoke, on the port alone: a 48-node batch from
    ``random_graph_batch``, finite logits and a finite gradient."""
    cfg = get_arch("pna").smoke()
    gen = torch.Generator().manual_seed(0)
    gb = p_gd.random_graph_batch(gen, 48, 160, cfg.d_in,
                                 n_labels=cfg.n_classes, device="cpu")
    params = p_pna.init_params(torch.Generator().manual_seed(1), cfg,
                               device="cpu")
    out = p_pna.forward(params, gb, cfg)
    assert tuple(out.shape) == (48, cfg.n_classes)
    assert bool(torch.isfinite(out).all())
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    grads = torch.autograd.grad(p_pna.loss_fn(params, gb, cfg), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ------------------------------------------------------------- graph data

@pytest.mark.parametrize("geometric", [False, True])
def test_random_graph_batch(geometric):
    """The reference's fields, dtypes and ranges; the same seed gives the
    same batch."""
    want = jax.eval_shape(lambda k: r_gd.random_graph_batch(
        k, 24, 72, 0 if geometric else 5, geometric=geometric, batch=4),
        jax.random.PRNGKey(0))
    b1, b2 = (p_gd.random_graph_batch(torch.Generator().manual_seed(7), 24,
                                      72, 0 if geometric else 5,
                                      geometric=geometric, batch=4,
                                      device="cpu") for _ in range(2))
    for f in dataclasses.fields(p_gd.GraphBatch):
        w, g1, g2 = (getattr(x, f.name) for x in (want, b1, b2))
        if w is None:
            assert g1 is None, f.name
            continue
        assert tuple(g1.shape) == tuple(w.shape), f.name
        assert str(g1.dtype).split(".")[-1] == str(w.dtype), f.name
        assert torch.equal(g1, g2), f.name
    assert int(b1.edge_src.max()) < 24 and int(b1.labels.max()) < 8
    assert b1.graph_id.tolist() == [i * 4 // 24 for i in range(24)]


def test_build_triplets_equal():
    rng = np.random.default_rng(9)
    src, dst = rng.integers(0, 10, 40), rng.integers(0, 10, 40)
    for cap in (None, 16):
        for g, w in zip(p_gd.build_triplets(src, dst, cap),
                        r_gd.build_triplets(src, dst, cap)):
            np.testing.assert_array_equal(g, w)

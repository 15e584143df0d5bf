"""The port's view-fed GNN == the reference's (DESIGN.md §14).

Both packages build the same seeded graph and take the same writes.  The
port's view-fed ``GraphBatch`` must equal the reference's field for field
and a batch re-extracted from scratch (a views-off twin running the view's
MATCH), under all three freshness policies and across writes; the sampler's
draws must be identical arrays; SAGE on parameters converted from the
reference's (``interop.sage_params_from_arrays``) must give the reference's
logits on the segment path (rtol 1e-5, atol 1e-6) and through
``block_spmm`` (its plain version here; rtol 2e-4, atol 2e-4, the
reference's own tolerance for its Pallas path), and two epochs of training
the reference's per-step losses and parameters (rtol 1e-4).  Then the
session surface: ``train_on_view``, ``embed_on_view``, ``ViewEmbedder``
behind the serve engine's write fences, ``ViewHandle`` and the facade.
"""
import jax
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.graphops import sampler as r_sampler
from repro.launch import gnn as r_gnn
from repro.models.gnn import graphdata as r_gd
from repro.models.gnn import sage as r_sage
from repro_torch import interop
from repro_torch.graphops import sampler as p_sampler
from repro_torch.graphops import view_subgraph as p_vs
from repro_torch.launch import gnn as p_gnn
from repro_torch.models.gnn import graphdata as p_gd
from repro_torch.models.gnn import sage as p_sage
from repro_torch.utils import host

V_DDL = ("CREATE VIEW V AS (CONSTRUCT (s)-[r:V]->(d) "
         "MATCH (s:A)-[:x]->(m:B)-[:y]->(d:C))")
Q_MATCH = "MATCH (s:A)-[:x]->(m:B)-[:y]->(d:C)"
GNN = {R: r_gnn, P: p_gnn}
FIELDS = ("node_feat", "edge_src", "edge_dst", "edge_mask", "node_mask",
          "graph_id", "labels", "edge_weight")


def _graph(pkg, seed=0, n=24):
    """test_view_gnn's graph: A -x-> B -y-> C, and a label z no view reads."""
    rng = np.random.default_rng(seed)
    schema = pkg.GraphSchema()
    b = pkg.GraphBuilder(schema)
    A = [b.add_node("A") for _ in range(n)]
    B = [b.add_node("B") for _ in range(n)]
    C = [b.add_node("C") for _ in range(n)]
    for i in range(n):
        for j in rng.choice(n, 2, replace=False):
            b.add_edge(A[i], B[int(j)], "x")
        b.add_edge(B[i], C[(i * 5 + 1) % n], "y")
        b.add_edge(C[i], A[(i + 3) % n], "z")
    kw = {"device": "cpu"} if pkg is P else {}
    return b.finalize(edge_cap=4096, **kw), schema, (A, B, C)


def _session(pkg, refresh="", views=True, seed=0):
    g, schema, abc = _graph(pkg, seed)
    kw = {"device": "cpu"} if pkg is P else {}
    sess = pkg.GraphSession(g, schema, **kw)
    if views:
        sess.create_view(V_DDL + refresh)
    return sess, abc


def _arrays(batch):
    return {f: (None if getattr(batch, f) is None else
                host(getattr(batch, f)) if hasattr(getattr(batch, f), "cpu")
                else np.asarray(getattr(batch, f))) for f in FIELDS}


def _batches_equal(a, b):
    a, b = _arrays(a), _arrays(b)
    for f in FIELDS:
        if a[f] is None or b[f] is None:
            assert a[f] is None and b[f] is None, f
            continue
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _twin_batch(twin):
    """The port's re-extraction from scratch: the view's MATCH on a
    views-off port session, through the same canonical builder."""
    rows = twin.query(Q_MATCH, use_views=False).pairs()
    return p_vs.build_graphbatch(
        rows.src.astype(np.int64), rows.dst.astype(np.int64),
        node_label=host(twin.g.node_label), num_nodes=int(twin.g.node_cap),
        weight=rows.count.astype(np.int64), device="cpu")


def _writes(pkg, A, B, k=0):
    return pkg.WriteBatch(edge_creates=[(A[k], B[(k + 7) % len(B)], "x"),
                                        (A[(k + 1) % len(A)], B[k], "x")])


def _both(refresh=""):
    """{pkg: (view session, nodes)} and the port's views-off twin."""
    return ({pkg: _session(pkg, refresh) for pkg in (R, P)},
            _session(P, views=False)[0])


def _ref_params(cfg=r_sage.SAGEConfig(), seed=0):
    """The reference's SAGE initialisation, as host arrays."""
    return jax.tree_util.tree_map(
        np.asarray, r_sage.init_params(jax.random.PRNGKey(seed), cfg))


# ---------------------------------------------------------------------------
# view-fed batches: port == reference == from-scratch twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("refresh", ["", " REFRESH DEFERRED",
                                     " REFRESH STALENESS 100"])
def test_view_batch_matches_reference_and_scratch(refresh):
    s, twin = _both(refresh)
    pb = s[P][0].view("V").subgraph(weighted=True).to_graphbatch()
    assert pb.node_feat.device.type == "cpu"
    _batches_equal(pb, s[R][0].view("V").subgraph(weighted=True)
                   .to_graphbatch())
    _batches_equal(pb, _twin_batch(twin))


@pytest.mark.parametrize("refresh", ["", " REFRESH DEFERRED"])
def test_view_batch_tracks_writes(refresh):
    s, twin = _both(refresh)
    A, B, _ = s[P][1]
    subs = {pkg: s[pkg][0].view("V").subgraph(weighted=True)
            for pkg in (R, P)}
    for k in range(3):
        for pkg in (R, P):
            s[pkg][0].apply_writes(_writes(pkg, A, B, k))
        twin.apply_writes(_writes(P, A, B, k))
        for sub in subs.values():
            sub.refresh()
        _batches_equal(subs[P].to_graphbatch(), _twin_batch(twin))
        _batches_equal(subs[P].to_graphbatch(), subs[R].to_graphbatch())
    for pkg in (R, P):        # builder edge order is the same in both
        s[pkg][0].apply_writes(pkg.WriteBatch(edge_deletes=[0]))
    twin.apply_writes(P.WriteBatch(edge_deletes=[0]))
    for sub in subs.values():
        sub.refresh()
    _batches_equal(subs[P].to_graphbatch(), _twin_batch(twin))
    _batches_equal(subs[P].to_graphbatch(), subs[R].to_graphbatch())
    assert subs[P].csr_rebuilds == subs[R].csr_rebuilds
    assert s[P][0].check_consistency("V")


def test_bounded_stale_batch_is_prewrite_until_drain():
    s, twin = _both(" REFRESH STALENESS 100")
    A, B, _ = s[P][1]
    sub = s[P][0].view("V").subgraph(weighted=True)
    rsub = s[R][0].view("V").subgraph(weighted=True)
    before = sub.to_graphbatch()
    for pkg in (R, P):
        s[pkg][0].apply_writes(_writes(pkg, A, B))
    twin.apply_writes(_writes(P, A, B))
    assert not sub.refresh() and not rsub.refresh()
    assert s[P][0].view("V").is_stale
    _batches_equal(sub.to_graphbatch(), before)
    _batches_equal(sub.to_graphbatch(), rsub.to_graphbatch())
    assert sub.refresh(drain=True) and rsub.refresh(drain=True)
    assert not s[P][0].view("V").is_stale
    _batches_equal(sub.to_graphbatch(), _twin_batch(twin))
    _batches_equal(sub.to_graphbatch(), rsub.to_graphbatch())


def test_incremental_refresh_skips_untouched_labels():
    s, _ = _both(" REFRESH DEFERRED")
    A, B, C = s[P][1]
    subs = {pkg: s[pkg][0].view("V").subgraph() for pkg in (R, P)}
    v0, r0 = subs[P].version, subs[P].slice_rebuilds["V"]
    for pkg in (R, P):
        s[pkg][0].apply_writes(pkg.WriteBatch(edge_creates=[(C[0], A[0],
                                                             "z")]))
        assert not subs[pkg].refresh()
    assert subs[P].version == v0 and subs[P].slice_rebuilds["V"] == r0
    for pkg in (R, P):
        s[pkg][0].apply_writes(_writes(pkg, A, B))
        assert subs[pkg].refresh()
    assert subs[P].version == v0 + 1 and subs[P].slice_rebuilds["V"] == r0 + 1
    for attr in ("version", "csr_rebuilds", "slice_rebuilds"):
        assert getattr(subs[P], attr) == getattr(subs[R], attr), attr
    for a, b in zip(subs[P].csr(), subs[R].csr()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(subs[P].seed_nodes(), subs[R].seed_nodes())


def test_extra_labels_mix_base_edges_as_the_reference():
    s, _ = _both()
    subs = {pkg: s[pkg][0].view("V").subgraph(extra_labels=("z",),
                                              weighted=True)
            for pkg in (R, P)}
    for a, b in zip(subs[P].edges(), subs[R].edges()):
        np.testing.assert_array_equal(a, b)
    _batches_equal(subs[P].to_graphbatch(), subs[R].to_graphbatch())


def test_subgraph_cache_and_drop_eviction():
    sess, _ = _session(P)
    h = sess.view("V")
    assert h.subgraph() is h.subgraph()
    assert h.subgraph(weighted=True) is not h.subgraph()
    h.drop()
    assert sess._subgraphs == {}
    with pytest.raises(ValueError):
        h.subgraph()


# ---------------------------------------------------------------------------
# sampler: the port's draws are the reference's arrays
# ---------------------------------------------------------------------------

def _random_csr(seed=0, n=500, e=4000):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e), n


@pytest.mark.parametrize("fanout", [[4, 4], [3], [2, 3, 2]])
def test_sampler_equals_reference(fanout):
    src, dst, n = _random_csr()
    smp = p_sampler.NeighborSampler(src, dst, n)
    ref = r_sampler.NeighborSampler(src, dst, n)
    np.testing.assert_array_equal(smp.indptr, ref.indptr)
    np.testing.assert_array_equal(smp.nbrs, ref.nbrs)
    seeds = np.unique(np.random.default_rng(1).integers(0, n, 40))
    for seed in (7, 8):
        a = smp.sample(seeds, fanout, seed=seed)
        b = ref.sample(seeds, fanout, seed=seed)
        assert type(a).__name__ == type(b).__name__ == "SampledSubgraph"
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        for x, y in zip(smp._sample_loop(seeds, fanout, seed=seed),
                        ref._sample_loop(seeds, fanout, seed=seed)):
            np.testing.assert_array_equal(x, y)
    assert p_sampler.max_subgraph_size(64, fanout) == \
        r_sampler.max_subgraph_size(64, fanout)


def test_sampler_deterministic_and_valid():
    src, dst, n = _random_csr()
    smp = p_sampler.NeighborSampler(src, dst, n)
    seeds = np.unique(np.random.default_rng(1).integers(0, n, 40))
    a = smp.sample(seeds, [4, 4], seed=7)
    for x, y in zip(a, smp.sample(seeds, [4, 4], seed=7)):
        assert np.array_equal(x, y)
    c = smp.sample(seeds, [4, 4], seed=8)
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    real = set(zip(dst.tolist(), src.tolist()))   # (node, in-neighbor)
    ids = a.node_ids
    for u, v in zip(a.edge_src, a.edge_dst):
        assert (int(ids[v]), int(ids[u])) in real
    assert np.array_equal(ids[: seeds.size], seeds)
    assert np.unique(ids).size == ids.size
    node_ids, es, ed, pos = a
    assert node_ids is a.node_ids and pos.size == seeds.size


def test_sampler_layer_counts_match_loop():
    src, dst, n = _random_csr(seed=3)
    smp = p_sampler.NeighborSampler(src, dst, n)
    seeds = np.unique(np.random.default_rng(2).integers(0, n, 30))
    sg = smp.sample(seeds, [3], seed=5)
    deg = smp.indptr[seeds + 1] - smp.indptr[seeds]
    counts = np.bincount(sg.edge_dst, minlength=seeds.size)[: seeds.size]
    assert np.array_equal(counts, np.minimum(deg, 3))
    loop = smp._sample_loop(seeds, [3], seed=5)
    assert np.array_equal(
        counts, np.bincount(loop[2], minlength=seeds.size)[: seeds.size])


def test_sampler_from_csr_matches_constructor():
    src, dst, n = _random_csr(seed=4)
    a = p_sampler.NeighborSampler(src, dst, n)
    b = p_sampler.NeighborSampler.from_csr(a.indptr, a.nbrs, n)
    seeds = np.arange(0, n, 37)
    for x, y in zip(a.sample(seeds, [3, 2], seed=1),
                    b.sample(seeds, [3, 2], seed=1)):
        assert np.array_equal(x, y)


def test_csr_helpers_equal_reference():
    from repro.graphops import csr as r_csr
    from repro_torch.graphops import csr as p_csr
    src, dst, n = _random_csr(seed=5, n=60, e=300)
    for x, y in zip(p_csr.build_csr(src, dst, n), r_csr.build_csr(src, dst, n)):
        np.testing.assert_array_equal(x, y)
    for md in (None, 3):
        a, wa = p_csr.ell_from_coo(src, dst, n, max_deg=md)
        b, wb = r_csr.ell_from_coo(src, dst, n, max_deg=md)
        assert wa == wb
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# SAGE on converted parameters
# ---------------------------------------------------------------------------

def _sage_inputs(seed=0, n=100, e=300):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n, 11)).astype(np.float32),
             rng.integers(0, n, e).astype(np.int32),
             rng.integers(0, n, e).astype(np.int32)),
            dict(labels=rng.integers(0, 8, n).astype(np.int32),
                 edge_weight=rng.integers(1, 4, e).astype(np.float32)))


@pytest.mark.parametrize("use_block_spmm", [False, True])
def test_sage_forward_equals_reference(use_block_spmm):
    args, kw = _sage_inputs()
    rcfg = r_sage.SAGEConfig(use_block_spmm=use_block_spmm, interpret=True)
    pcfg = p_sage.SAGEConfig(use_block_spmm=use_block_spmm)
    arrays = _ref_params()
    params = interop.sage_params_from_arrays(arrays, device="cpu")
    assert sorted(params) == ["enc", "head", "nbr0", "nbr1", "self0",
                              "self1"]
    assert params["nbr0"].keys() == {"w"} and params["head"]["w"].shape == \
        (128, 8)
    want = np.asarray(r_sage.forward(
        _ref_params(), rcfg, r_gd.pad_graph(*args, **kw)))
    got = host(p_sage.forward(params, pcfg,
                              p_gd.pad_graph(*args, **kw, device="cpu")))
    tol = dict(rtol=2e-4, atol=2e-4) if use_block_spmm else \
        dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, **tol)


def test_sage_block_spmm_path_equals_segment_path():
    args, kw = _sage_inputs(seed=1)
    params = interop.sage_params_from_arrays(_ref_params(), device="cpu")
    batch = p_gd.pad_graph(*args, **kw, device="cpu")
    seg = p_sage.forward(params, p_sage.SAGEConfig(), batch)
    spmm = p_sage.forward(params, p_sage.SAGEConfig(use_block_spmm=True),
                          batch)
    np.testing.assert_allclose(host(spmm), host(seg), rtol=2e-4, atol=2e-4)


def test_sage_loss_equals_reference():
    args, kw = _sage_inputs(seed=2)
    rl, ra = r_sage.loss_fn(_ref_params(), r_sage.SAGEConfig(),
                            r_gd.pad_graph(*args, **kw))
    pl, pa = p_sage.loss_fn(
        interop.sage_params_from_arrays(_ref_params(), device="cpu"),
        p_sage.SAGEConfig(), p_gd.pad_graph(*args, **kw, device="cpu"))
    np.testing.assert_allclose(float(pl), float(rl), rtol=1e-5)
    assert float(pa) == pytest.approx(float(ra))


def test_two_epochs_train_as_the_reference():
    """epoch_batches + the train step from the same converted parameters:
    the same batches, per-step losses and updated parameters."""
    s, _ = _both(" REFRESH DEFERRED")
    A, B, _ = s[P][1]
    cfg = {pkg: GNN[pkg].TrainConfig(epochs=2, batch_nodes=8, fanout=(3, 3))
           for pkg in (R, P)}
    subs = {pkg: s[pkg][0].view("V").subgraph() for pkg in (R, P)}
    steps = {pkg: GNN[pkg]._train_step(GNN[pkg]._model_cfg(cfg[pkg]))
             for pkg in (R, P)}
    arrays = _ref_params(r_gnn._model_cfg(cfg[R]))
    params = {R: jax.tree_util.tree_map(jax.numpy.asarray, arrays),
              P: interop.sage_params_from_arrays(arrays, device="cpu")}
    losses = {R: [], P: []}
    for epoch in range(2):
        if epoch == 1:                      # a write between epochs
            for pkg in (R, P):
                s[pkg][0].apply_writes(_writes(pkg, A, B))
        for pkg in (R, P):
            subs[pkg].refresh()
        pairs = list(zip(r_gnn.epoch_batches(subs[R], cfg[R], epoch),
                         p_gnn.epoch_batches(subs[P], cfg[P], epoch)))
        assert pairs
        for rb, pb in pairs:
            _batches_equal(pb, rb)
            for pkg, b in ((R, rb), (P, pb)):
                params[pkg], loss, _ = steps[pkg](params[pkg], b, 1e-2)
                losses[pkg].append(float(loss))
    np.testing.assert_allclose(losses[P], losses[R], rtol=1e-4)
    for name, layer in params[R].items():
        for k, v in layer.items():
            np.testing.assert_allclose(host(params[P][name][k]),
                                       np.asarray(v), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}.{k}")


def test_block_spmm_training_raises():
    sess, _ = _session(P, " REFRESH DEFERRED")
    cfg = p_gnn.TrainConfig(epochs=1, batch_nodes=8, fanout=(3, 3),
                            use_block_spmm=True)
    with pytest.raises(ValueError, match="no backward"):
        p_gnn.train_on_view(sess, "V", cfg)


# ---------------------------------------------------------------------------
# the session surface
# ---------------------------------------------------------------------------

def test_train_on_view_smoke_and_maintained_refresh():
    sess, (A, B, C) = _session(P, " REFRESH DEFERRED")
    cfg = p_gnn.TrainConfig(epochs=2, batch_nodes=8, fanout=(3, 3), seed=0)
    params, rpt = p_gnn.train_on_view(sess, "V", cfg)
    assert rpt.epochs == 2 and rpt.steps > 0
    assert all(np.isfinite(x) for x in rpt.losses)
    assert params["enc"]["w"].device.type == "cpu"
    sess.apply_writes(_writes(P, A, B))
    _, rpt2 = p_gnn.train_on_view(sess, "V", cfg)
    assert rpt2.refreshes >= 1
    emb = p_gnn.embed_on_view(sess, "V", params, cfg)
    assert emb.shape[1] == cfg.d_hidden and np.isfinite(emb).all()


@pytest.mark.parametrize("use_block_spmm", [False, True])
def test_embed_on_view_equals_reference(use_block_spmm):
    s, _ = _both(" REFRESH DEFERRED")
    A, B, _ = s[P][1]
    arrays = _ref_params()
    params = {R: arrays,
              P: interop.sage_params_from_arrays(arrays, device="cpu")}
    cfg = {pkg: GNN[pkg].TrainConfig(use_block_spmm=use_block_spmm)
           for pkg in (R, P)}
    for pkg in (R, P):
        s[pkg][0].apply_writes(_writes(pkg, A, B))
    ids = s[P][0].view("V").subgraph().nodes()[::3]
    for node_ids in (None, np.concatenate([ids, [1, 2]])):
        got = p_gnn.embed_on_view(s[P][0], "V", params[P], cfg[P], node_ids)
        want = r_gnn.embed_on_view(s[R][0], "V", params[R], cfg[R], node_ids)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _served(refresh=" REFRESH DEFERRED"):
    sess, abc = _session(P, refresh)
    cfg = p_gnn.TrainConfig(epochs=1, batch_nodes=8, fanout=(3, 3), seed=0)
    params, _ = p_gnn.train_on_view(sess, "V", cfg)
    return sess, params, cfg, abc


def test_serve_embed_fenced_by_view_writes():
    sess, params, cfg, (A, B, C) = _served()
    ids = sess.view("V").subgraph().nodes()[:6]
    pre_direct = p_gnn.embed_on_view(sess, "V", params, cfg, node_ids=ids)
    eng = sess.serve()
    eng.register_embedder(p_gnn.ViewEmbedder(sess, "V", params, cfg))
    t_pre = eng.submit_embed("V", ids)
    eng.submit_writes(_writes(P, A, B))
    t_post = eng.submit_embed("V", ids)
    eng.run()
    np.testing.assert_allclose(t_pre.embed_result.embeddings, pre_direct,
                               rtol=1e-5, atol=1e-6)
    assert t_post.embed_result.version > t_pre.embed_result.version
    post_direct = p_gnn.embed_on_view(sess, "V", params, cfg, node_ids=ids)
    np.testing.assert_allclose(t_post.embed_result.embeddings, post_direct,
                               rtol=1e-5, atol=1e-6)
    assert eng.stats.embed_reads == 2 and eng.stats.embed_refreshes == 2
    assert t_pre.kind == "embed" and eng.result(t_pre) is t_pre.embed_result


def test_serve_embed_hoists_past_disjoint_fence():
    sess, params, cfg, (A, B, C) = _served()
    eng = sess.serve()
    eng.register_embedder(p_gnn.ViewEmbedder(sess, "V", params, cfg))
    ids = sess.view("V").subgraph().nodes()[:4]
    eng.submit_writes(P.WriteBatch(edge_creates=[(C[0], A[1], "z")]))
    t = eng.submit_embed("V", ids)
    eng.step()
    assert t.done and t.hoisted
    assert eng.stats.hoisted >= 1


def test_serve_embed_validation():
    sess, params, cfg, _ = _served()
    eng = sess.serve()
    with pytest.raises(ValueError):
        eng.submit_embed("nope", [1, 2])
    emb = p_gnn.ViewEmbedder(sess, "V", params, cfg)
    assert eng.register_embedder(emb) == "V"
    sess.drop_view("V")
    with pytest.raises(ValueError):
        eng.register_embedder(p_gnn.ViewEmbedder(sess, "V", params, cfg))


def test_view_handle_surface_and_delegation():
    sess, _ = _session(P, " REFRESH DEFERRED")
    h = sess.create_view(
        "CREATE VIEW W AS (CONSTRUCT (s)-[r:W]->(d) "
        "MATCH (s:B)-[:y]->(d:C))")
    assert isinstance(h, P.ViewHandle) and h.name == "W"
    assert h.stats().e_vl == len(h.pair_slot)
    smp = h.sampler(weighted=True)
    assert smp is h.subgraph(weighted=True).sampler()
    np.testing.assert_array_equal(smp.indptr, h.subgraph(weighted=True)
                                  .csr()[0])
    _batches_equal(h.to_graphbatch(), h.subgraph().to_graphbatch())
    _batches_equal(p_vs.view_to_graphbatch(sess, h),
                   h.subgraph().to_graphbatch())
    assert {x.name for x in sess.catalog()} == {"V", "W"}
    h.drop()
    with pytest.raises(ValueError):
        h.to_graphbatch()
    with pytest.raises(ValueError):
        sess.view("W")


def test_facade_exports_equal_reference():
    from repro import mv4pg as ref
    from repro_torch import mv4pg
    assert mv4pg.__all__ == ref.__all__
    for name in mv4pg.__all__:
        obj = getattr(mv4pg, name)
        assert obj.__module__.split(".")[0] == "repro_torch", name
    assert mv4pg.GraphSession.__module__ == "repro_torch.core.views"
    assert mv4pg.train_on_view is p_gnn.train_on_view

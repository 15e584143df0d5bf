"""block_spmm's slab map: the u8 route walks only the slabs of A that hold a
non-zero.

On the CPU the plain twin (``ref.spmm_slab_map_ref``) is held to the
definition (a 64 x 128 tile is live if and only if it holds a non-zero,
listed in ascending order, then -1, with its count), and a walk over its
live tiles alone (``ref.spmm_slab_walk_ref``) to ``F @ A``.  The engine
builds a map once per cached adjacency, builds it anew after a write evicts
the label, and shares it with a snapshot.  Tests marked ``cuda`` hold the
kernels' map to the twin and the walk to the plain version on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref

BK, BN = p_ops.SPMM_TILE[2], p_ops.SPMM_TILE[1]


def _adjacency(case: str, seed: int) -> np.ndarray:
    """An int32 A for each case: mostly empty, all zero, fully dense, ragged
    K and N, and edges in a label block near the diagonal."""
    rng = np.random.default_rng(seed)
    if case == "sparse":
        return (rng.random((640, 768)) < 0.0005).astype(np.int32)
    if case == "empty":
        return np.zeros((320, 384), np.int32)
    if case == "dense":
        return rng.integers(1, 4, (256, 384)).astype(np.int32)
    if case == "ragged":
        A = (rng.random((200, 301)) < 0.003).astype(np.int32)
        A[199, 300] = 2          # the last, partial tile is live
        return A
    # node ids contiguous by label: edges of one label block near its
    # diagonal, offsets of 1 + zipf as FinBench's transfers
    n = 1000
    A = np.zeros((n, n), np.int32)
    src = rng.integers(300, 700, 400)
    dst = np.minimum(src + rng.zipf(1.8, 400), 699)
    np.add.at(A, (src, dst), 1)
    return A


CASES = ["sparse", "empty", "dense", "ragged", "diagonal"]


def _tiles_live(A: np.ndarray) -> np.ndarray:
    """[n_colblocks, n_slabs] bool, tile by tile."""
    K, N = A.shape
    n_slabs, n_cb = -(-K // BK), -(-N // BN)
    live = np.zeros((n_cb, n_slabs), bool)
    for cb in range(n_cb):
        for ks in range(n_slabs):
            live[cb, ks] = A[ks * BK:(ks + 1) * BK,
                             cb * BN:(cb + 1) * BN].any()
    return live


@pytest.mark.parametrize("case", CASES)
def test_twin_lists_exactly_the_live_tiles(case):
    A = _adjacency(case, 1)
    slabs, counts = p_ref.spmm_slab_map_ref(torch.from_numpy(A))
    live = _tiles_live(A)
    assert slabs.dtype == torch.int16 and counts.dtype == torch.int32
    assert tuple(slabs.shape) == live.shape
    for cb in range(live.shape[0]):
        want = np.flatnonzero(live[cb])
        n = int(counts[cb])
        assert n == want.shape[0]
        np.testing.assert_array_equal(slabs[cb, :n].numpy(), want)
        assert (slabs[cb, n:] == -1).all()
    if case == "empty":
        assert int(counts.sum()) == 0
    if case == "dense":
        assert int(counts.sum()) == live.size


@pytest.mark.parametrize("case", CASES)
def test_walk_over_live_tiles_alone_equals_the_product(case):
    A = _adjacency(case, 2)
    F = np.random.default_rng(3).integers(0, 300, (37, A.shape[0]))
    tF, tA = torch.from_numpy(F), torch.from_numpy(A)
    slabs, counts = p_ref.spmm_slab_map_ref(tA)
    got = p_ref.spmm_slab_walk_ref(tF, tA, slabs, counts)
    assert torch.equal(got, tF.long() @ tA.long())


def test_map_on_the_cpu_is_the_twin_with_its_total():
    A = torch.from_numpy(_adjacency("diagonal", 4))
    smap = p_ops.spmm_slab_map(A)
    slabs, counts = p_ref.spmm_slab_map_ref(A)
    assert torch.equal(smap.slabs, slabs) and torch.equal(smap.counts, counts)
    assert smap.shape == tuple(A.shape)
    assert smap.read_live() == int(counts.sum())
    assert 0 < smap.read_live() < smap.tiles


def test_map_checks_its_operand():
    with pytest.raises(TypeError):
        p_ops.spmm_slab_map(torch.zeros((4, 4), dtype=torch.float32))
    F = torch.zeros((3, 64), dtype=torch.int32)
    smap = p_ops.spmm_slab_map(torch.zeros((64, 128), dtype=torch.int32))
    with pytest.raises(ValueError):      # a map of another shape
        p_ops.block_spmm(F, torch.zeros((64, 100), dtype=torch.int32),
                         slab_map=smap)


# ---------------------------------------------------------------------------
# the engine: one map per cached adjacency
# ---------------------------------------------------------------------------

def _session():
    import repro_torch.core as P
    rng = np.random.default_rng(5)
    schema = P.GraphSchema()
    b = P.GraphBuilder(schema)
    n = 150
    for _ in range(n):
        b.add_node("A")
    for u in range(n):
        for v in rng.choice(n, 2, replace=False):
            if u != v:
                b.add_edge(u, int(v), "x")
    g = b.finalize(device="cpu")
    cfg = P.ExecConfig(backend="dense", use_kernel=True, src_block=64)
    return P, P.GraphSession(g, schema, cfg, device="cpu")


Q = "MATCH (a:A)-[:x*1..2]->(b:A) RETURN a, b"


def _maps(sess):
    return {key: adj.spmm_slab_map
            for key, (_, adj) in sess.engine._adj_cache.items()}


def test_engine_builds_a_map_once_per_adjacency(monkeypatch):
    P, sess = _session()
    built = []
    orig = p_ops.spmm_slab_map

    def counted(A):
        built.append(A)
        return orig(A)

    monkeypatch.setattr(p_ops, "spmm_slab_map", counted)
    first = sess.query(Q).reach
    maps = _maps(sess)
    assert maps and len(built) == len(maps)
    for key, (_, adj) in sess.engine._adj_cache.items():
        slabs, counts = p_ref.spmm_slab_map_ref(adj)
        assert torch.equal(adj.spmm_slab_map.slabs, slabs)
        assert torch.equal(adj.spmm_slab_map.counts, counts)
    np.testing.assert_array_equal(sess.query(Q).reach, first)
    assert len(built) == len(maps)
    assert all(_maps(sess)[k] is m for k, m in maps.items())


def test_engine_builds_the_map_anew_after_a_write():
    P, sess = _session()
    sess.query(Q)
    old = _maps(sess)
    sess.apply_writes(P.WriteBatch(edge_creates=[(0, 149, "x")]))
    sess.query(Q)
    new = _maps(sess)
    assert set(new) == set(old)
    for key, (_, adj) in sess.engine._adj_cache.items():
        assert new[key] is not old[key]
        slabs, counts = p_ref.spmm_slab_map_ref(adj)
        assert torch.equal(new[key].slabs, slabs)
        assert torch.equal(new[key].counts, counts)


def test_snapshot_shares_the_maps():
    P, sess = _session()
    sess.query(Q)
    eng = sess.engine
    snap = eng.snapshot()
    lid = sess.schema.edge_label_id("x")
    keys = [k for k in eng._adj_cache if k[0] == lid]
    assert keys
    for key in keys:
        misses = snap.misses
        A = snap.adj(*key)
        assert snap.misses == misses
        assert A is eng._adj_cache[key][1]
        assert A.spmm_slab_map is eng._adj_cache[key][1].spmm_slab_map


def test_engine_without_the_kernel_builds_no_map():
    _, sess = _session()
    sess.engine.cfg.use_kernel = False
    sess.engine._adj_cache.clear()
    sess.query(Q)
    cached = [adj for _, adj in sess.engine._adj_cache.values()]
    assert cached
    assert all(getattr(A, "spmm_slab_map", None) is None for A in cached)


def test_live_slab_share_reads_the_reads_counts():
    """The benchmark's reader: Σ ``spmm_live_slabs`` ÷ Σ ``spmm_dense_slabs``
    over the spans under the ``session.query`` roots, fences left out;
    nothing where no span carries the counts.  The live counts, added by
    ``trace.add_later``, are read when the record is."""
    from torch.profiler import ProfilerActivity, profile

    from mvbench import harness
    from repro_torch.utils import trace
    reader = harness.plugin("metrics", "kernel.spmm_live_slab_share.analytic",
                            harness.BENCH_DIR.parent, ["mvbench"])
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("session.query"):
            pass
    assert reader.read({}) is None
    read = []

    def live(n):
        read.append(n)
        return n

    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("session.query"):
            trace.add_later("spmm_live_slabs", lambda: live(3))
            trace.add("spmm_dense_slabs", 200)
            with trace.span("exec.prepare"):
                trace.add_later("spmm_live_slabs", lambda: live(1))
                trace.add("spmm_dense_slabs", 200)
        with trace.span("maint.apply"):
            trace.add_later("spmm_live_slabs", lambda: live(50))
            trace.add("spmm_dense_slabs", 50)
    assert read == []          # the counts are read with the record
    assert reader.read({}) == pytest.approx(1.0)
    assert sorted(read) == [1, 3, 50]
    assert reader.read({}) == pytest.approx(1.0)   # and added once


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_map_equals_the_twin(cuda_device, case):
    A = torch.from_numpy(_adjacency(case, 6)).to(cuda_device)
    smap = p_ops.spmm_slab_map(A)
    slabs, counts = p_ref.spmm_slab_map_ref(A)
    assert torch.equal(smap.slabs, slabs)
    assert torch.equal(smap.counts, counts)
    assert smap.read_live() == int(counts.sum())


def _walk_operands(dev):
    """S = 130 (one block of two row tiles), K = 320 (5 slabs), N = 300
    (3 column blocks): column block 0 holds slab 1 (values up to 255) and
    slab 3 (a value 300: the CUDA cores); column block 1 holds nothing;
    column block 2 holds the ragged corner of slab 4."""
    rng = np.random.default_rng(7)
    S, K, N = 130, 320, 300
    A = np.zeros((K, N), np.int64)
    A[64:128, :128] = (rng.random((64, 128)) < 0.05) * rng.integers(
        1, 256, (64, 128))
    A[192:256, :128] = rng.random((64, 128)) < 0.05
    A[200, 17] = 300
    A[256:320, 256:300] = rng.random((64, 44)) < 0.1
    F = rng.integers(0, 3, (S, K))
    return (torch.from_numpy(F.astype(np.int32)).to(dev),
            torch.from_numpy(A.astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(0, 2, N)).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("semiring", ["count", "bool"])
def test_cuda_walk_is_exact(cuda_device, semiring, masked):
    F, A, mask = _walk_operands(cuda_device)
    m = mask if masked else None
    counting = semiring == "count"
    out_dtype = torch.int32 if counting else torch.uint8
    smap = p_ops.spmm_slab_map(A)
    assert smap.counts.tolist() == [2, 0, 1]
    slow = p_ops.spmm_slow_slabs(cuda_device)
    slow.zero_()
    maps0 = p_ops.spmm_slab_map.launches
    got = p_ops.block_spmm(F, A, m, counting=counting, out_dtype=out_dtype,
                           slab_map=smap)
    assert p_ops.spmm_slab_map.launches == maps0    # the map given is used
    want = p_ref.block_spmm_ref(F, A, m, semiring=semiring)
    assert got.dtype == out_dtype
    assert torch.equal(got.to(torch.float32), want)
    assert (got[:, 128:256] == 0).all()      # the empty column block
    assert int(slow) == 1                    # slab 3 of column block 0
    # the same bits with a map built in the call
    assert torch.equal(p_ops.block_spmm(F, A, m, counting=counting,
                                        out_dtype=out_dtype), got)
    assert p_ops.spmm_slab_map.launches == maps0 + 1


@pytest.mark.cuda
def test_cuda_walk_over_a_dense_map_gives_the_same_bits(cuda_device):
    """A map that lists every slab walks A as a dense A is walked."""
    F, A, _ = _walk_operands(cuda_device)
    smap = p_ops.spmm_slab_map(A)
    n_cb, n_slabs = smap.slabs.shape
    full = p_ops.SlabMap(
        torch.arange(n_slabs, dtype=torch.int16,
                     device=cuda_device).repeat(n_cb, 1),
        torch.full((n_cb,), n_slabs, dtype=torch.int32, device=cuda_device),
        smap.shape)
    assert torch.equal(
        p_ops.block_spmm(F, A, counting=True, out_dtype=torch.int32,
                         slab_map=smap),
        p_ops.block_spmm(F, A, counting=True, out_dtype=torch.int32,
                         slab_map=full))

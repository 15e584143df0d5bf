"""block_spmm: the port's wrapper against the reference kernel and oracle.

On the CPU the wrapper takes the plain PyTorch version; it must agree with
the reference Pallas kernel (interpret mode) and ``ref.block_spmm_ref``:
bit-exact on integer-valued inputs, within the reference's own rtol on
random floats.  Tests marked ``cuda`` hold the CUDA kernel against the plain
version on the card and skip on a host without one: the u8 tensor-core
route for integer operands (values above 255 in some K slabs send those
slabs to the CUDA cores) and the fp32 route for float operands.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import build as p_build
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref

SHAPES = [(8, 16, 12), (128, 128, 128), (100, 200, 150), (256, 384, 128)]
DTYPES = {"float32": torch.float32, "int32": torch.int32}


@pytest.fixture(scope="module")
def R():
    """The JAX reference: its kernel wrappers, its oracles and ``jnp``.  The
    GPU machine has no JAX, so there only the ``cuda`` tests run."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops, ref
    return SimpleNamespace(jnp=jnp, ops=ops, ref=ref,
                           dtype={torch.float32: jnp.float32,
                                  torch.int32: jnp.int32})


def _inputs(shape, seed):
    S, K, N = shape
    rng = np.random.default_rng(seed)
    F = rng.integers(0, 3, (S, K))
    A = (rng.random((K, N)) < 0.2).astype(np.int32)
    mask = rng.integers(0, 2, (N,)).astype(np.float32)
    return F, A, mask


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("semiring", ["count", "bool"])
@pytest.mark.parametrize("shape", SHAPES)
def test_block_spmm_matches_reference(R, shape, semiring, dtype, masked):
    F, A, mask = _inputs(shape, 2 * SHAPES.index(shape) + (semiring == "bool"))
    tdt = DTYPES[dtype]
    jdt = R.dtype[tdt]
    counting = semiring == "count"
    m = mask if masked else None
    got = p_ops.block_spmm(
        torch.from_numpy(F).to(tdt), torch.from_numpy(A).to(tdt),
        None if m is None else torch.from_numpy(m), counting=counting)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[::2]
    jm = None if m is None else R.jnp.asarray(m)
    kernel = R.ops.block_spmm(R.jnp.asarray(F, jdt), R.jnp.asarray(A, jdt), jm,
                              counting=counting)
    oracle = R.ref.block_spmm_ref(R.jnp.asarray(F, jdt), R.jnp.asarray(A, jdt),
                                  jm, semiring=semiring)
    # integer-valued inputs: every partial sum is exact in fp32
    np.testing.assert_array_equal(got.numpy(), np.asarray(kernel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.uint8])
def test_block_spmm_integer_outputs(R, out_dtype):
    F, A, mask = _inputs((100, 200, 150), 5)
    counting = out_dtype == torch.int32
    got = p_ops.block_spmm(torch.from_numpy(F).to(torch.int32),
                           torch.from_numpy(A), torch.from_numpy(mask),
                           counting=counting, out_dtype=out_dtype)
    want = R.ref.block_spmm_ref(R.jnp.asarray(F), R.jnp.asarray(A),
                                R.jnp.asarray(mask),
                                semiring="count" if counting else "bool")
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(got.numpy().dtype))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(64, 64, 64), (100, 200, 150)])
def test_block_spmm_random_floats(R, shape, masked):
    S, K, N = shape
    rng = np.random.default_rng(0)
    F = rng.random((S, K)).astype(np.float32)
    A = rng.random((K, N)).astype(np.float32)
    mask = rng.integers(0, 2, (N,)).astype(np.float32) if masked else None
    got = p_ops.block_spmm(torch.from_numpy(F), torch.from_numpy(A),
                           None if mask is None else torch.from_numpy(mask))
    want = R.ops.block_spmm(R.jnp.asarray(F), R.jnp.asarray(A),
                            None if mask is None else R.jnp.asarray(mask))
    # sums of random floats in another order: the reference's own rtol
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6 if masked else 1e-5)


def _wide_inputs(case, seed):
    """Integer operands whose values leave 0..255: everywhere (``above``)
    or only in the second 64-deep K slab (``mixed``), with every sum
    below 2^24 so that the fp32 reference stays exact."""
    rng = np.random.default_rng(seed)
    S, K, N = 130, 200, 150
    F = rng.integers(0, 3, (S, K))
    A = (rng.random((K, N)) < 0.3).astype(np.int64)
    if case == "above":
        F = F * rng.integers(100, 1000, (S, K))
        A = A * rng.integers(1, 300, (K, N))
    else:
        F[:, 64:128] *= 300
        A[64:128] *= 257
    assert int((F @ A).max()) < 2 ** 24 and int(max(F.max(), A.max())) > 255
    return F.astype(np.int32), A.astype(np.int32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", ["above", "mixed"])
def test_block_spmm_above_255_matches_reference(R, case, masked):
    """Walk counts and multiplicities above 255 (which the card's u8 route
    sends to the CUDA cores slab by slab): the plain version equals the
    reference kernel and oracle exactly."""
    F, A = _wide_inputs(case, 21)
    mask = np.random.default_rng(22).integers(0, 2, (A.shape[1],)).astype(
        np.float32) if masked else None
    got = p_ops.block_spmm(torch.from_numpy(F), torch.from_numpy(A),
                           None if mask is None else torch.from_numpy(mask),
                           counting=True, out_dtype=torch.int32)
    jm = None if mask is None else R.jnp.asarray(mask)
    kernel = R.ops.block_spmm(R.jnp.asarray(F), R.jnp.asarray(A), jm)
    oracle = R.ref.block_spmm_ref(R.jnp.asarray(F), R.jnp.asarray(A), jm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kernel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))


def test_block_spmm_hop_equivalence_with_executor():
    """The kernel hop is exactly one dense executor hop (both packages)."""
    import repro.core as R
    import repro_torch.core as P
    rng = np.random.default_rng(3)
    n = 20
    edges = [(u, v) for u in range(n) for v in range(n)
             if u != v and rng.random() < 0.2]
    q = "MATCH (a:A)-[:x*1..2]->(b:A) RETURN a, b"
    out = {}
    for pkg, kw in ((R, {}), (P, {"device": "cpu"})):
        schema = pkg.GraphSchema()
        b = pkg.GraphBuilder(schema)
        for _ in range(n):
            b.add_node("A")
        for u, v in edges:
            b.add_edge(u, v, "x")
        g = b.finalize(**kw)
        kernel_kw = {"use_pallas": True} if pkg is R else {"use_kernel": True}
        for name, extra in (("plain", {}), ("kernel", kernel_kw)):
            cfg = pkg.ExecConfig(backend="dense", src_block=32, **extra)
            out[(pkg.__name__, name)] = pkg.PathExecutor(
                g, schema, cfg).run_query(pkg.parse_query(q)).reach
    ref = out[("repro.core", "plain")]
    for key, reach in out.items():
        np.testing.assert_array_equal(reach, ref, err_msg=str(key))


def test_wrapper_checks_shapes_and_devices():
    F = torch.zeros((4, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        p_ops.block_spmm(F, torch.zeros((6, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        p_ops.block_spmm(F, torch.zeros((5, 3), dtype=torch.int32),
                         torch.ones(4))
    with pytest.raises(ValueError):   # uint8 only carries the bool semiring
        p_ops.block_spmm(F, torch.zeros((5, 3), dtype=torch.int32),
                         out_dtype=torch.uint8)
    with pytest.raises(ValueError):   # neither cpu nor cuda: no fallback
        p_ops.block_spmm(F.to("meta"),
                         torch.zeros((5, 3), dtype=torch.int32, device="meta"))


def test_no_silent_host_fallback(monkeypatch, tmp_path):
    """Entry points default to the card and raise without one; the kernel
    build raises without nvcc instead of degrading to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import repro_torch.core as P
    schema = P.GraphSchema()
    b = P.GraphBuilder(schema)
    b.add_node("A")
    with pytest.raises(RuntimeError, match="CUDA"):
        b.finalize()
    g = b.finalize(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.GraphSession(g, schema)
    assert P.GraphSession(g, schema, device="cpu").device.type == "cpu"
    monkeypatch.setattr(p_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(p_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(p_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        p_build.build("block_spmm")


def test_cpu_tensors_never_count_kernel_launches():
    before = p_ops.block_spmm.launches
    p_ops.block_spmm(torch.ones((3, 4)), torch.ones((4, 5)))
    assert p_ops.block_spmm.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("semiring", ["count", "bool"])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, shape, semiring):
    F, A, mask = _inputs(shape, 11)
    args = [torch.from_numpy(x).to(cuda_device) for x in (F, A, mask)]
    args[0] = args[0].to(torch.int32)
    before = p_ops.block_spmm.launches
    got = p_ops.block_spmm(*args, counting=semiring == "count")
    assert p_ops.block_spmm.launches == before + 1
    want = p_ref.block_spmm_ref(*args, semiring=semiring)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", ["small", "above", "mixed"])
def test_cuda_u8_route_exact(cuda_device, case, masked):
    """Integer operands take the u8 tensor-core route, exact; slabs with a
    value above 255 run on the CUDA cores, and only those."""
    if case == "small":
        F, A, _ = _inputs((130, 200, 150), 23)
        F = F.astype(np.int32)
    else:
        F, A = _wide_inputs(case, 24)
    mask = torch.from_numpy(np.random.default_rng(25).integers(
        0, 2, (A.shape[1],))).to(cuda_device) if masked else None
    tF, tA = (torch.from_numpy(x).to(cuda_device) for x in (F, A))
    slow = p_ops.spmm_slow_slabs(cuda_device)
    slow.zero_()
    before = p_ops.block_spmm.launches_by_route["tc"]
    got = p_ops.block_spmm(tF, tA, mask, counting=True,
                           out_dtype=torch.int32)
    assert p_ops.block_spmm.launches_by_route["tc"] == before + 1
    want = p_ref.block_spmm_ref(tF, tA, mask)
    assert torch.equal(got.to(torch.float32), want)
    # one block of two row tiles, two column blocks, four K slabs
    assert int(slow) == {"small": 0, "above": 8, "mixed": 2}[case]


# fp32 route shapes: one split by the plan, then S <= 128 with K >= 8,192
# (split many ways), ragged N, and K % 4 != 0 as well
FP32_SHAPES = [(100, 200, 150), (64, 8192, 128), (100, 9000, 150),
               (37, 8195, 61)]


@pytest.mark.cuda
@pytest.mark.parametrize("semiring", ["count", "bool"])
@pytest.mark.parametrize("shape", FP32_SHAPES)
def test_cuda_fp32_route(cuda_device, semiring, shape):
    """A float32 operand takes the fp32 CUDA-core route, split over K where
    the plan says so, exact on integer values."""
    F, A, mask = _inputs(shape, 26)
    tF, tA, tm = (torch.from_numpy(x).to(cuda_device, torch.float32)
                  for x in (F, A, mask))
    before = p_ops.block_spmm.launches_by_route["fp32"]
    got = p_ops.block_spmm(tF, tA.to(torch.int32), tm,
                           counting=semiring == "count")
    assert p_ops.block_spmm.launches_by_route["fp32"] == before + 1
    assert torch.equal(got, p_ref.block_spmm_ref(tF, tA, tm,
                                                 semiring=semiring))
    if shape[1] >= 8192:
        assert p_ops.spmm_fp32_launch_plan(tF, tA).n_split > 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FP32_SHAPES)
def test_cuda_fp32_route_gives_the_same_bits_twice(cuda_device, shape):
    """The partials are added in split order, with no float atomics: two
    launches on random fp32 operands agree bit for bit."""
    S, K, N = shape
    rng = np.random.default_rng(27)
    tF = torch.from_numpy(rng.random((S, K), dtype=np.float32)).to(
        cuda_device)
    tA = torch.from_numpy(rng.random((K, N), dtype=np.float32)).to(
        cuda_device)
    first = p_ops.block_spmm(tF, tA)
    assert torch.equal(first, p_ops.block_spmm(tF, tA))
    torch.testing.assert_close(first, p_ref.block_spmm_ref(tF, tA),
                               rtol=2 * (K + 1) * 2.0 ** -24, atol=1e-6)


@pytest.mark.cuda
def test_cuda_sage_aggregates_on_the_fp32_route(cuda_device):
    """SAGE's aggregation with ``use_block_spmm`` launches the fp32 route
    once a layer on the card and equals the segment path within the
    reference's tolerance for its Pallas path (rtol 2e-4, atol 2e-4)."""
    from repro_torch.models.gnn import graphdata, sage
    rng = np.random.default_rng(27)
    n, e = 300, 1200
    batch = graphdata.pad_graph(
        rng.normal(size=(n, 11)).astype(np.float32),
        rng.integers(0, n, e).astype(np.int32),
        rng.integers(0, n, e).astype(np.int32),
        labels=rng.integers(0, 8, n).astype(np.int32),
        edge_weight=rng.integers(1, 4, e).astype(np.float32),
        device=cuda_device)
    cfg = sage.SAGEConfig()
    params = sage.init_params(torch.Generator().manual_seed(0), cfg,
                              device=cuda_device)
    before = p_ops.block_spmm.launches_by_route["fp32"]
    with torch.no_grad():
        got = sage.forward(params, sage.SAGEConfig(use_block_spmm=True),
                           batch)
        want = sage.forward(params, cfg, batch)
    assert p_ops.block_spmm.launches_by_route["fp32"] == \
        before + cfg.n_layers
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)

"""block_spmm: the port's wrapper against the reference kernel and oracle.

On the CPU the wrapper takes the plain PyTorch version; it must agree with
the reference Pallas kernel (interpret mode) and ``ref.block_spmm_ref``:
bit-exact on integer-valued inputs, within the reference's own rtol on
random floats.  Tests marked ``cuda`` hold the CUDA kernel against the plain
version on the card and skip on a host without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.kernels import build as p_build
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref

SHAPES = [(8, 16, 12), (128, 128, 128), (100, 200, 150), (256, 384, 128)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "int32": (jnp.int32, torch.int32)}


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
def test_block_spmm_matches_reference(shape, semiring, dtype, masked):
    F, A, mask = _inputs(shape, 2 * SHAPES.index(shape) + (semiring == "bool"))
    jdt, tdt = DTYPES[dtype]
    counting = semiring == "count"
    m = mask if masked else None
    got = p_ops.block_spmm(
        torch.from_numpy(F).to(tdt), torch.from_numpy(A).to(tdt),
        None if m is None else torch.from_numpy(m), counting=counting)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[::2]
    jm = None if m is None else jnp.asarray(m)
    kernel = r_ops.block_spmm(jnp.asarray(F, jdt), jnp.asarray(A, jdt), jm,
                              counting=counting)
    oracle = r_ref.block_spmm_ref(jnp.asarray(F, jdt), jnp.asarray(A, jdt),
                                  jm, semiring=semiring)
    # integer-valued inputs: every partial sum is exact in fp32
    np.testing.assert_array_equal(got.numpy(), np.asarray(kernel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.uint8])
def test_block_spmm_integer_outputs(out_dtype):
    F, A, mask = _inputs((100, 200, 150), 5)
    counting = out_dtype == torch.int32
    got = p_ops.block_spmm(torch.from_numpy(F).to(torch.int32),
                           torch.from_numpy(A), torch.from_numpy(mask),
                           counting=counting, out_dtype=out_dtype)
    want = r_ref.block_spmm_ref(jnp.asarray(F), jnp.asarray(A),
                                jnp.asarray(mask),
                                semiring="count" if counting else "bool")
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(got.numpy().dtype))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(64, 64, 64), (100, 200, 150)])
def test_block_spmm_random_floats(shape, masked):
    S, K, N = shape
    rng = np.random.default_rng(0)
    F = rng.random((S, K)).astype(np.float32)
    A = rng.random((K, N)).astype(np.float32)
    mask = rng.integers(0, 2, (N,)).astype(np.float32) if masked else None
    got = p_ops.block_spmm(torch.from_numpy(F), torch.from_numpy(A),
                           None if mask is None else torch.from_numpy(mask))
    want = r_ops.block_spmm(jnp.asarray(F), jnp.asarray(A),
                            None if mask is None else jnp.asarray(mask))
    # sums of random floats in another order: the reference's own rtol
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6 if masked else 1e-5)


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

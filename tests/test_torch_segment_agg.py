"""segment_multi_agg and bucketize_messages: the port against the reference.

The same numpy-seeded inputs go through the reference (``repro.kernels.ops``,
the Pallas kernel in interpret mode, and ``ref.segment_multi_agg_ref``) and
through the port's wrapper on CPU tensors, which takes the plain version.
Tolerances are the reference's own (``tests/test_kernels.py``): 1e-5 for
float32 messages, 2e-2 for bfloat16.  ``bucketize_messages`` must return the
reference loop's arrays exactly.  Tests marked ``cuda`` hold the CUDA kernel
against its plain version on the card and skip on a host without one.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref

SHAPES = [(16, 4, 8), (64, 16, 128), (33, 7, 75)]
# W > 64, W = 1 and two slot chunks, N not a multiple of the kernel's 8 rows
# a block; D = 96 fills every lane's columns, 75 leaves some idle, 300 and
# 333 take several column chunks of 128
EDGE_SHAPES = [(257, 70, 96), (9, 1, 75), (50, 33, 333), (40, 40, 300)]
DTYPES = {"float32": (torch.float32, 1e-5),
          "bfloat16": (torch.bfloat16, 2e-2)}


@pytest.fixture(scope="module")
def R():
    """The JAX reference: its kernel wrappers, its oracles and ``jnp``.  The
    GPU machine has no JAX, so there only the ``cuda`` tests run."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops, ref
    return SimpleNamespace(jnp=jnp, ops=ops, ref=ref,
                           dtype={torch.float32: jnp.float32,
                                  torch.bfloat16: jnp.bfloat16})


def _inputs(shape, seed):
    N, W, D = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, W, D)).astype(np.float32),
            rng.random((N, W)) < 0.7)


def _edge_inputs(shape, seed):
    """Like ``_inputs``, with row 0 all valid and rows 1-2 (where they
    exist) empty."""
    msg, valid = _inputs(shape, seed)
    valid[0] = True
    valid[1:3] = False
    return msg, valid


def _nan_inputs(D, seed=5):
    """[24, 40, D] messages with a NaN in a valid slot before finite values
    (row 0, column 3), one in the last valid slot after them (row 1,
    column 5) and one in an invalid slot (row 2, column 7)."""
    msg, valid = _edge_inputs((24, 40, D), seed)
    valid[0:2, :6] = True
    valid[1, 6:] = False
    valid[2, 9], valid[2, 10] = False, True
    msg[0, 0, 3] = msg[1, 5, 5] = msg[2, 9, 7] = np.nan
    return msg, valid


def _edges(seed, E=200, N=32, D=16):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, N, E)
    dst[dst == 5] = 6                     # node 5 gets no message
    return dst, rng.standard_normal((E, D)).astype(np.float32), N


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_segment_multi_agg_matches_reference(R, shape, dtype):
    # the reference test's seeds: on them its kernel and its oracle agree
    # within 1e-5 (they take meansq - mean² with two roundings and with one)
    msg, valid = _inputs(shape, hash(shape) % 2 ** 31)
    tdt, tol = DTYPES[dtype]
    jdt = R.dtype[tdt]
    got = p_ops.segment_multi_agg(torch.from_numpy(msg).to(tdt),
                                  torch.from_numpy(valid))
    jmsg = R.jnp.asarray(msg, jdt)
    kernel = R.ops.segment_multi_agg(jmsg, R.jnp.asarray(valid))
    oracle = R.ref.segment_multi_agg_ref(jmsg.astype(R.jnp.float32),
                                         R.jnp.asarray(valid))
    for g, k, o in zip(got, kernel, oracle):
        assert g.dtype == torch.float32 and tuple(g.shape) == (shape[0],
                                                               shape[2])
        np.testing.assert_allclose(g.numpy(), np.asarray(k), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(g.numpy(), np.asarray(o), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_segment_multi_agg_edge_shapes_match_reference(R, shape, dtype):
    """All four outputs against the reference kernel; mean, max and min
    also against its oracle.  The oracle takes meansq - mean² with two
    roundings, and rows of one valid slot (all of them at W = 1) magnify
    that in the std (``test_segment_agg_std_rounds_like_the_reference_
    kernel``), so the std is held to the kernel alone."""
    msg, valid = _edge_inputs(shape, 17)
    tdt, tol = DTYPES[dtype]
    got = p_ops.segment_multi_agg(torch.from_numpy(msg).to(tdt),
                                  torch.from_numpy(valid))
    jmsg = R.jnp.asarray(msg, R.dtype[tdt])
    kernel = R.ops.segment_multi_agg(jmsg, R.jnp.asarray(valid))
    oracle = R.ref.segment_multi_agg_ref(jmsg.astype(R.jnp.float32),
                                         R.jnp.asarray(valid))
    for i, (g, k, o) in enumerate(zip(got, kernel, oracle)):
        assert tuple(g.shape) == (shape[0], shape[2])
        np.testing.assert_allclose(g.numpy(), np.asarray(k), rtol=tol,
                                   atol=tol)
        if i < 3:
            np.testing.assert_allclose(g.numpy(), np.asarray(o), rtol=tol,
                                       atol=tol)
    for out in got:                       # rows 1-2 hold no valid slot
        assert not out[1:3].any()


@pytest.mark.parametrize("D", [75, 96])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_segment_agg_nan_matches_reference(R, dtype, D):
    """A NaN of a valid slot, before or after finite values, makes all four
    outputs of its column NaN in the reference (``jnp.max``/``jnp.min``
    propagate it) and in the port.  A NaN of an invalid slot stays out of
    max and min in both.  Mean and std take the invalid slot times 0, in
    the reference and in the port's plain version alike (NaN·0); the CUDA
    kernel never reads it, so it needs invalid slots to be finite."""
    msg, valid = _nan_inputs(D)
    tdt, tol = DTYPES[dtype]
    got = p_ops.segment_multi_agg(torch.from_numpy(msg).to(tdt),
                                  torch.from_numpy(valid))
    jmsg = R.jnp.asarray(msg, R.dtype[tdt])
    kernel = [np.asarray(k) for k in
              R.ops.segment_multi_agg(jmsg, R.jnp.asarray(valid))]
    oracle = [np.asarray(o) for o in R.ref.segment_multi_agg_ref(
        jmsg.astype(R.jnp.float32), R.jnp.asarray(valid))]
    for i, (g, k, o) in enumerate(zip(got, kernel, oracle)):
        g = g.numpy()
        assert np.isnan(g[0, 3]) and np.isnan(g[1, 5])
        assert np.isnan(k[0, 3]) and np.isnan(k[1, 5])
        np.testing.assert_allclose(g, k, rtol=tol, atol=tol)
        if i < 3:
            np.testing.assert_allclose(g, o, rtol=tol, atol=tol)
        if i in (1, 2):                   # max and min
            assert np.isfinite(g[2]).all() and np.isfinite(k[2]).all()


def test_segment_agg_std_rounds_like_the_reference_kernel(R):
    """Rows with one valid slot have variance 0 up to rounding, and the
    std sqrt(var + 1e-5) magnifies that residual 158-fold.  The port takes
    meansq - mean² with one rounding, as the reference kernel's compiled
    expression does: the two agree to 1e-6 there."""
    msg, _ = _inputs((64, 4, 32), 3)
    valid = np.zeros((64, 4), bool)
    valid[np.arange(64), np.arange(64) % 4] = True
    got = p_ops.segment_multi_agg(torch.from_numpy(msg),
                                  torch.from_numpy(valid))
    want = R.ops.segment_multi_agg(R.jnp.asarray(msg), R.jnp.asarray(valid))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=0, atol=1e-6)


def test_segment_agg_empty_rows_are_zero():
    msg = torch.ones((8, 4, 16))
    for valid in (torch.zeros((8, 4), dtype=torch.bool),
                  torch.zeros((8, 4), dtype=torch.uint8)):
        for out in p_ops.segment_multi_agg(msg, valid):
            assert torch.equal(out, torch.zeros((8, 16)))


def test_segment_agg_against_scatter_oracle(R):
    """The bucketed layout agrees with a scatter formulation of the same
    aggregates (sum and count by ``index_add_``, max and min by
    ``scatter_reduce``), and with the reference's bucketing + kernel."""
    dst, msg, N = _edges(11)
    bucketed, valid = p_ops.bucketize_messages(dst, torch.from_numpy(msg), N)
    mean, mx, mn, std = p_ops.segment_multi_agg(bucketed, valid)
    t_dst = torch.from_numpy(dst)
    t_msg = torch.from_numpy(msg)
    s = torch.zeros((N, msg.shape[1])).index_add_(0, t_dst, t_msg)
    sq = torch.zeros((N, msg.shape[1])).index_add_(0, t_dst, t_msg * t_msg)
    cnt = torch.zeros(N).index_add_(0, t_dst, torch.ones(len(dst)))[:, None]
    want_mean = s / cnt.clamp_min(1.0)
    idx = t_dst[:, None].expand_as(t_msg)
    want_max = torch.zeros((N, msg.shape[1])).scatter_reduce(
        0, idx, t_msg, "amax", include_self=False)
    want_min = torch.zeros((N, msg.shape[1])).scatter_reduce(
        0, idx, t_msg, "amin", include_self=False)
    # meansq - mean² with one rounding, as the kernel takes it
    var = ((sq / cnt.clamp_min(1.0)).double() - want_mean.double() ** 2)
    want_std = torch.where(cnt > 0, torch.sqrt(
        torch.clamp_min(var.float(), 0.0) + 1e-5), 0.0)
    # sums in another order than the bucketed walk: float32 rounding
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(std, want_std, rtol=1e-5, atol=1e-5)
    assert torch.equal(mx, want_max) and torch.equal(mn, want_min)
    assert torch.equal(mean[5], torch.zeros(msg.shape[1]))
    rb, rv = R.ops.bucketize_messages(dst, msg, N)
    ref_mean, *_ = R.ops.segment_multi_agg(R.jnp.asarray(rb), R.jnp.asarray(rv))
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("width", [None, 3, 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_bucketize_matches_reference_loop(R, seed, width):
    """Slot k of node d holds the k-th edge to d in edge order; width 3 is
    below the maximum in-degree and truncates, 40 pads."""
    dst, msg, N = _edges(seed)
    want, want_valid = R.ops.bucketize_messages(dst, msg, N, width)
    for d in (dst, torch.from_numpy(dst).to(torch.int32)):
        got, valid = p_ops.bucketize_messages(d, torch.from_numpy(msg), N,
                                              width)
        assert got.dtype == torch.float32 and valid.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(valid.numpy(), want_valid)


def test_bucketize_edge_cases(R):
    msg = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    for dst, N in (([2, 2, 2], 4), ([], 3), ([0, 1, 1], 2)):
        m = msg[:len(dst)]
        want, want_valid = R.ops.bucketize_messages(
            np.asarray(dst, np.int64), m.numpy(), N)
        got, valid = p_ops.bucketize_messages(
            torch.tensor(dst, dtype=torch.int64), m, N)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(valid.numpy(), want_valid)
    bf, _ = p_ops.bucketize_messages([1, 0], msg[:2].to(torch.bfloat16), 2)
    assert bf.dtype == torch.bfloat16
    with pytest.raises(ValueError):   # a destination past num_nodes
        p_ops.bucketize_messages([0, 3], msg[:2], 2)
    with pytest.raises(ValueError):
        p_ops.bucketize_messages([0, 1], msg, 2)


def test_segment_agg_wrapper_checks():
    msg = torch.zeros((4, 3, 5))
    with pytest.raises(ValueError):
        p_ops.segment_multi_agg(msg, torch.zeros((4, 2), dtype=torch.bool))
    with pytest.raises(TypeError):
        p_ops.segment_multi_agg(msg.to(torch.float64),
                                torch.zeros((4, 3), dtype=torch.bool))
    with pytest.raises(TypeError):
        p_ops.segment_multi_agg(msg, torch.zeros((4, 3)))
    with pytest.raises(ValueError):   # neither cpu nor cuda: no fallback
        p_ops.segment_multi_agg(msg.to("meta"),
                                torch.zeros((4, 3), dtype=torch.bool,
                                            device="meta"))


def test_cpu_tensors_never_count_kernel_launches():
    before = p_ops.segment_multi_agg.launches
    p_ops.segment_multi_agg(torch.ones((2, 3, 4)),
                            torch.ones((2, 3), dtype=torch.bool))
    assert p_ops.segment_multi_agg.launches == before


def _cuda_matches_plain(device, msg, valid, dtype, equal_nan=False,
                        rows=slice(None)):
    """One launch of the kernel, held to the plain version on the card: max
    and min in every row, mean and std in ``rows``."""
    tdt, tol = DTYPES[dtype]
    m = msg.to(device, tdt)
    v = valid.to(device)
    before = p_ops.segment_multi_agg.launches
    got = p_ops.segment_multi_agg(m, v)
    assert p_ops.segment_multi_agg.launches == before + 1
    want = p_ref.segment_multi_agg_ref(m.to(torch.float32), v)
    for i, (g, w) in enumerate(zip(got, want)):
        if i in (0, 3):                   # mean and std
            g, w = g[rows], w[rows]
        torch.testing.assert_close(g, w, rtol=tol, atol=tol,
                                   equal_nan=equal_nan)
    return got


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES + [(1000, 45, 75)])
def test_cuda_kernel_matches_plain(cuda_device, shape, dtype):
    msg, valid = _inputs(shape, 7)
    _cuda_matches_plain(cuda_device, torch.from_numpy(msg),
                        torch.from_numpy(valid), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_cuda_edge_shapes_match_plain(cuda_device, shape, dtype):
    msg, valid = _edge_inputs(shape, 7)
    got = _cuda_matches_plain(cuda_device, torch.from_numpy(msg),
                              torch.from_numpy(valid), dtype)
    for out in got:
        assert not out[1:3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [75, 96])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_nan_matches_plain(cuda_device, dtype, D):
    """The reference's NaN max and min, on the card: a NaN of a valid slot
    reaches all four outputs of its column, one of an invalid slot (row 2)
    neither max nor min.  Row 2's mean and std are not compared: the plain
    version takes the invalid slot times 0, as the reference does, and the
    kernel never reads it (invalid slots must be finite)."""
    msg, valid = _nan_inputs(D)
    got = _cuda_matches_plain(cuda_device, torch.from_numpy(msg),
                              torch.from_numpy(valid), dtype, equal_nan=True,
                              rows=torch.arange(24, device=cuda_device) != 2)
    for i, out in enumerate(got):
        assert bool(out[0, 3].isnan()) and bool(out[1, 5].isnan())
        if i in (1, 2):
            assert bool(out[2].isfinite().all())


@pytest.mark.cuda
def test_cuda_bucketize_matches_host(cuda_device):
    dst, msg, N = _edges(3)
    want = p_ops.bucketize_messages(dst, torch.from_numpy(msg), N)
    got = p_ops.bucketize_messages(torch.from_numpy(dst).to(cuda_device),
                                   torch.from_numpy(msg).to(cuda_device), N)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)

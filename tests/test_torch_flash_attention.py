"""flash_attention: the port against the reference kernel and oracles.

The same numpy-seeded q, k and v go through the reference
(``repro.kernels.ops.flash_attention``, the Pallas kernel in interpret mode,
and ``ref.mha_ref``) and through the port's wrapper on CPU tensors, which
takes its plain version ``flash_attention_ref``.  Tolerances are the
reference's own (``tests/test_kernels.py``): 2e-5 for float32, 3e-2 for
bfloat16.  Tests marked ``cuda`` hold the CUDA kernel against its plain
version on the card and skip on a host without one.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref

SHAPES = [(1, 2, 128, 64), (2, 4, 256, 128), (1, 1, 384, 128)]
DTYPES = {"float32": (torch.float32, 2e-5),
          "bfloat16": (torch.bfloat16, 3e-2)}


@pytest.fixture(scope="module")
def R():
    """The JAX reference: its kernel wrappers, its oracles and ``jnp``.  The
    GPU machine has no JAX, so there only the ``cuda`` tests run."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops, ref
    return SimpleNamespace(jnp=jnp, ops=ops, ref=ref,
                           dtype={torch.float32: jnp.float32,
                                  torch.bfloat16: jnp.bfloat16})


def _qkv(seed, B, Hq, Hkv, Sq, Sk, D, qk_scale=0.5):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Hq, Sq, D)) * qk_scale).astype(np.float32)
    k = (rng.standard_normal((B, Hkv, Sk, D)) * qk_scale).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    return q, k, v


def _port(q, k, v, tdt, causal):
    out = p_ops.flash_attention(*(torch.from_numpy(x).to(tdt)
                                  for x in (q, k, v)), causal=causal)
    assert out.dtype == tdt and tuple(out.shape) == q.shape
    return out.to(torch.float32).numpy()


def _mha(R, q, k, v, causal):
    """The reference oracle in float32 on KV heads repeated for GQA."""
    rep = q.shape[1] // k.shape[1]
    k, v = (np.repeat(x, rep, axis=1) for x in (k, v))
    return np.asarray(R.ref.mha_ref(*(R.jnp.asarray(x) for x in (q, k, v)),
                                    causal=causal))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES + [(1, 2, 128, 256)])
def test_flash_attention_matches_reference(R, shape, causal, dtype):
    B, H, S, D = shape
    q, k, v = _qkv(SHAPES.index(shape) if shape in SHAPES else 9,
                   B, H, H, S, S, D)
    tdt, tol = DTYPES[dtype]
    jdt = R.dtype[tdt]
    got = _port(q, k, v, tdt, causal)
    kernel = R.ops.flash_attention(*(R.jnp.asarray(x, jdt) for x in (q, k, v)),
                                   causal=causal)
    oracle = R.ref.mha_ref(*(R.jnp.asarray(x, jdt).astype(R.jnp.float32)
                             for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got, np.asarray(kernel, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_gqa_by_index(R, dtype):
    """Query head h reads KV head h // (Hq/Hkv): the reference wrapper's
    ``jnp.repeat`` semantics, without repeating K and V."""
    q, k, v = _qkv(5, 2, 8, 2, 128, 128, 64, qk_scale=1.0)
    tdt, tol = DTYPES[dtype]
    jdt = R.dtype[tdt]
    got = _port(q, k, v, tdt, True)
    want = R.ops.flash_attention(*(R.jnp.asarray(x, jdt) for x in (q, k, v)),
                                 causal=True)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_flash_attention_decode_offset(R):
    """Sq < Sk: the causal diagonal shifts by Sk - Sq (chunked decode)."""
    q, k, v = _qkv(6, 1, 2, 2, 128, 384, 64, qk_scale=1.0)
    got = _port(q, k, v, torch.float32, True)
    want = R.ops.flash_attention(*(R.jnp.asarray(x) for x in (q, k, v)),
                                 causal=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _mha(R, q, k, v, True), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_lengths(R, causal):
    """Lengths that are no multiple of a tile, which the reference wrapper
    does not take: held against the reference oracle alone (float32)."""
    q, k, v = _qkv(8, 2, 4, 2, 100, 173, 64)
    np.testing.assert_allclose(_port(q, k, v, torch.float32, causal),
                               _mha(R, q, k, v, causal), rtol=2e-5, atol=2e-5)


def test_flash_attention_ref_keeps_probabilities_in_float32():
    """``mha_ref`` rounds p to v's bfloat16 before the product; the kernel's
    plain version keeps p and v in float32, as the Pallas kernel does."""
    q, k, v = _qkv(2, 1, 2, 2, 128, 128, 64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    exact = p_ref.flash_attention_ref(*(x.to(torch.float32)
                                        for x in (tq, tk, tv)))
    got = p_ref.flash_attention_ref(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, exact.to(torch.bfloat16))
    rounded = p_ref.mha_ref(tq.to(torch.float32), tk.to(torch.float32), tv)
    assert not torch.equal(rounded, got)


def test_port_oracles_match_reference_oracles(R):
    q, k, v = _qkv(3, 2, 2, 2, 16, 24, 8)
    for causal in (True, False):
        got = p_ref.mha_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=causal)
        want = R.ref.mha_ref(*(R.jnp.asarray(x) for x in (q, k, v)),
                             causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    kv_len = np.array([24, 10])
    got = p_ref.decode_attention_ref(torch.from_numpy(q[:, :, 0]),
                                     torch.from_numpy(k), torch.from_numpy(v),
                                     torch.from_numpy(kv_len))
    want = R.ref.decode_attention_ref(R.jnp.asarray(q[:, :, 0]), R.jnp.asarray(k),
                                      R.jnp.asarray(v), R.jnp.asarray(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_wrapper_checks():
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="Sk >= Sq"):
        p_ops.flash_attention(q, q[:, :, :4], q[:, :, :4])
    with pytest.raises(ValueError, match="head_dim"):
        p_ops.flash_attention(q[..., :32], q[..., :32], q[..., :32])
    with pytest.raises(ValueError):      # 2 query heads over 3 KV heads
        p_ops.flash_attention(q, torch.zeros((1, 3, 8, 64)),
                              torch.zeros((1, 3, 8, 64)))
    with pytest.raises(ValueError):
        p_ops.flash_attention(q, q, q[:, :, :4])
    with pytest.raises(TypeError):
        p_ops.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(TypeError):
        p_ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):      # neither cpu nor cuda: no fallback
        m = q.to("meta")
        p_ops.flash_attention(m, m, m)


def test_cpu_tensors_never_count_kernel_launches():
    before = p_ops.flash_attention.launches
    q = torch.ones((1, 1, 4, 64))
    p_ops.flash_attention(q, q, q)
    assert p_ops.flash_attention.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", [(2, 4, 2, 128, 128, 64),
                                  (1, 8, 1, 100, 173, 128),
                                  (1, 2, 2, 64, 320, 256),
                                  (1, 2, 1, 1, 97, 128)])
def test_cuda_kernel_matches_plain(cuda_device, dims, causal, dtype):
    tdt, tol = DTYPES[dtype]
    q, k, v = (torch.from_numpy(x).to(cuda_device, tdt)
               for x in _qkv(4, *dims))
    before = p_ops.flash_attention.launches
    got = p_ops.flash_attention(q, k, v, causal=causal)
    assert p_ops.flash_attention.launches == before + 1
    want = p_ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.to(torch.float32), want.to(torch.float32),
                               rtol=tol, atol=tol)

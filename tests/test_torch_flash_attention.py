"""flash_attention: the port against the reference kernel and oracles.

The same numpy-seeded q, k and v go through the reference
(``repro.kernels.ops.flash_attention``, the Pallas kernel in interpret mode,
and ``ref.mha_ref``) and through the port's wrapper on CPU tensors, which
takes its plain version ``flash_attention_ref``.  Tolerances are the
reference's own (``tests/test_kernels.py``): 2e-5 for float32, 3e-2 for
bfloat16.  Tests marked ``cuda`` hold the CUDA kernel against its plain
version on the card and skip on a host without one; the tensor-core route
(bf16) is held to one bf16 step there (``BF16_STEP``, the tolerance of
``chip_smoke.py``), the CUDA-core route (fp32) to 2e-5.
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
# (rtol, atol) of one bf16 step: kernel and plain version compute in fp32
# and round once to bf16
BF16_STEP = (2 ** -7, 1e-4)


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


def _plain_partials(q, k, v, causal, n_split):
    """Split-KV partials in plain float32: the keys cut into ``n_split``
    chunks with a shorter last one; each chunk's unnormalised ``p @ v``,
    row max m and row sum l (m = -1e30, l = 0 where a row sees no key of
    the chunk)."""
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    rep = tq.shape[1] // tk.shape[1]
    tk, tv = (x.repeat_interleave(rep, dim=1) for x in (tk, tv))
    Sq, Sk, D = tq.shape[2], tk.shape[2], tq.shape[3]
    per = -(-Sk // n_split) + (Sk % n_split == 0 and n_split > 1)
    bounds = list(range(0, Sk, per)) + [Sk]
    assert len(bounds) - 1 == n_split
    seen = p_ref._causal_mask(Sq, Sk, "cpu") if causal else \
        torch.ones((Sq, Sk), dtype=torch.bool)
    accs, ms, ls = [], [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        s = p_ref.matmul_f32(tq, tk[:, :, a:b].transpose(-1, -2)) / D ** 0.5
        vis = seen[:, a:b]
        s = torch.where(vis, s, -1e30)
        m = s.amax(dim=-1)
        p = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
        accs.append(p_ref.matmul_f32(p, tv[:, :, a:b]))
        ms.append(m)
        ls.append(p.sum(dim=-1))
    return torch.stack(accs), torch.stack(ms), torch.stack(ls)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", [(1, 2, 2, 128, 640, 64),
                                  (2, 4, 2, 128, 640, 64)],
                         ids=["decode", "gqa"])
@pytest.mark.parametrize("n_split", [1, 3, 8])
def test_merge_attention_partials_matches_reference(R, n_split, dims,
                                                    causal):
    """Split over keys: plain partials of 1, 3 or 8 chunks (the last one
    shorter) merged by ``merge_attention_partials`` equal the reference
    kernel.  Under the causal decode mask the last chunks see no key of
    the first rows, which the merge must weigh by 0."""
    q, k, v = _qkv(10 + n_split, *dims)
    acc, m, l = _plain_partials(q, k, v, causal, n_split)
    if causal and n_split == 8:
        assert bool((l == 0).any())
    got = p_ref.merge_attention_partials(acc, m, l)
    want = R.ops.flash_attention(*(R.jnp.asarray(x) for x in (q, k, v)),
                                 causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _bf16_route_numerics(q, k, v, split_p):
    """A plain emulation of the tensor-core route's arithmetic: bf16 q, k,
    v; scores in fp32 (products of bf16 values are exact) scaled after the
    product; p = exp(s - m) in fp32; then ``Ph @ V + Pl @ V`` with
    ``Ph = bf16(p)``, ``Pl = bf16(p - Ph)`` (or ``Ph @ V`` alone when not
    ``split_p``), over l = sum p, rounded once to bf16."""
    hq, hkv, d = q.shape[1], k.shape[1], q.shape[-1]
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    kf, vf = (x.repeat_interleave(hq // hkv, dim=1) for x in (kf, vf))
    s = p_ref.matmul_f32(qf, kf.transpose(-1, -2)) * (1.0 / d ** 0.5)
    s = torch.where(p_ref._causal_mask(q.shape[2], k.shape[2], "cpu"), s,
                    -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ph = p.to(torch.bfloat16).to(torch.float32)
    acc = p_ref.matmul_f32(ph, vf)
    if split_p:
        acc = acc + p_ref.matmul_f32(
            (p - ph).to(torch.bfloat16).to(torch.float32), vf)
    return (acc / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def test_bf16_probability_split_keeps_one_step():
    """With P split into two bf16 halves the tensor-core route's numerics
    stay within one bf16 step of ``flash_attention_ref`` at a 4096-key
    decode shape.  A single bf16 P does not: on these inputs 70 of the
    65,536 outputs leave the step (max abs error 4.9e-4 against 2.4e-4),
    and before the final rounding its median relative error is 1.6e-3
    against 2.4e-6 for the split."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(0, 1, 4, 1, 128, 4096, 128, qk_scale=1.0))
    want = p_ref.flash_attention_ref(q, k, v).to(torch.float32)
    rtol, atol = BF16_STEP
    split = _bf16_route_numerics(q, k, v, True).to(torch.float32)
    single = _bf16_route_numerics(q, k, v, False).to(torch.float32)
    assert torch.allclose(split, want, rtol=rtol, atol=atol)
    assert not torch.allclose(single, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dims, want", [
    ((1, 24, 4096, 4096, 128), (1, 64)),     # starcoder2-3b prefill
    ((1, 8, 4096, 4096, 256), (1, 128)),     # gemma-2b prefill
    ((1, 24, 128, 4096, 128), (6, 11)),      # starcoder2-3b chunked decode
    ((1, 24, 1, 4096, 128), (11, 6)),        # one-token decode
    ((1, 8, 37, 3001, 256), (32, 3)),        # ragged, 32-key tiles
    ((1, 1, 1, 40, 64), (1, 1)),             # one kv tile
])
def test_attention_splits(dims, want):
    """Enough chunks for about two blocks per SM (132 on an H100), at most
    one per kv tile, the last chunk shorter, none empty."""
    B, Hq, Sq, Sk, D = dims
    n_split, per = p_ops.attention_splits(B, Hq, Sq, Sk, D, 132)
    assert (n_split, per) == want
    n_kv = -(-Sk // p_ops.ATTN_TILE_K[D])
    assert (n_split - 1) * per < n_kv <= n_split * per
    if n_split > 1:
        assert B * Hq * -(-Sq // p_ops.ATTN_BLOCK_Q) < 132
        assert B * Hq * -(-Sq // p_ops.ATTN_BLOCK_Q) * n_split >= 132


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", [(1, 24, 2, 1, 4096, 128),
                                  (1, 8, 1, 37, 3001, 256),
                                  (1, 6, 2, 128, 4096, 128),
                                  (2, 4, 2, 100, 173, 64)])
def test_cuda_routes_match_plain(cuda_device, dims, causal, dtype):
    """bf16 takes the tensor-core route (split over keys at these decode
    shapes but the last) within one bf16 step; fp32 the CUDA-core route
    within 2e-5."""
    tdt = DTYPES[dtype][0]
    rtol, atol = BF16_STEP if tdt == torch.bfloat16 else (2e-5, 2e-5)
    route = "tc" if tdt == torch.bfloat16 else "fp32"
    q, k, v = (torch.from_numpy(x).to(cuda_device, tdt)
               for x in _qkv(7, *dims, qk_scale=1.0))
    before = dict(p_ops.flash_attention.launches_by_route)
    got = p_ops.flash_attention(q, k, v, causal=causal)
    assert p_ops.flash_attention.launches_by_route[route] == before[route] + 1
    want = p_ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.to(torch.float32), want.to(torch.float32),
                               rtol=rtol, atol=atol)

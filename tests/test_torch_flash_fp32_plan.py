"""flash_attention's fp32 route: the split over keys, planned on the host.

The planner (``ops.attention_splits`` with the fp32 kernel's 64-row blocks,
32-key tiles and ``one_wave``) is plain Python: how a block's kv tiles are
cut into chunks against the card's resident slots.  The CUDA kernel that follows the
plan runs only on the card (``chip_smoke.py`` phase 6, the ``cuda`` cases
below); here a plain emulation of its arithmetic, chunk by chunk and tile
by tile, merged by ``ref.merge_attention_partials``, must equal the JAX
reference's ``flash_attention`` (interpret mode) within the fp32 tolerance
of the reference's own tests, 2e-5.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

H100_SMS = 132
MASKED = -1e30
# resident blocks of the fp32 kernel an SM assumed here, by head_dim, as
# its occupancy query reports them on an H100: its shared memory (61 KB,
# 110 KB, 208 KB a block) and register caps
OCCUPANCY = {64: 3, 128: 2, 256: 1}
# (B, Hq, Hkv, Sq, Sk, D) and the planned (n_split, tiles_per_split): the
# fp32 route's timed shape, starcoder2-3b's chunked decode and prefill, and
# chip_smoke's ATTN_SPLIT_SHAPES
PLANS = {
    "timed": ((2, 4, 4, 256, 256, 128), (8, 1)),
    "starcoder2-3b chunked decode": ((1, 24, 2, 128, 4096, 128), (5, 26)),
    "starcoder2-3b prefill": ((1, 24, 2, 4096, 4096, 128), (1, 128)),
    "one-token decode": ((1, 24, 2, 1, 4096, 128), (11, 12)),
    "ragged, D = 256": ((1, 8, 1, 37, 3001, 256), (16, 6)),
}


@pytest.fixture(scope="module")
def R():
    """The JAX reference's kernel wrappers.  The GPU machine has no JAX, so
    there only the ``cuda`` tests run."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as r_ops
    return SimpleNamespace(jnp=jnp, ops=r_ops)


def _plan(B, Hq, Hkv, Sq, Sk, D, n_sm=H100_SMS):
    return ops.attention_splits(B, Hq, Sq, Sk, D, n_sm,
                                ops.ATTN_FP32_BLOCK_Q, ops.ATTN_FP32_TILE_K,
                                OCCUPANCY[D], one_wave=True)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fp32_plan_at_the_timed_and_split_shapes(name):
    """At most one chunk per kv tile, none empty for the last query tile,
    the last one shorter or as long, and, while the query blocks are fewer
    than the SMs, one wave that fills the card: the blocks fit its
    resident slots, and one more chunk would not, unless every chunk is
    one tile already.  (At the decode shape the bf16 rule's six chunks
    would leave 24 of 288 blocks to a second wave.)"""
    dims, want = PLANS[name]
    B, Hq, Hkv, Sq, Sk, D = dims
    n_split, per = _plan(*dims)
    assert (n_split, per) == want
    n_kv = -(-Sk // ops.ATTN_FP32_TILE_K)
    assert 1 <= n_split <= n_kv
    assert (n_split - 1) * per < n_kv <= n_split * per
    blocks = B * Hq * -(-Sq // ops.ATTN_FP32_BLOCK_Q)
    if blocks >= H100_SMS:
        assert n_split == 1
    else:
        assert n_split > 1
        slots = H100_SMS * OCCUPANCY[D]
        assert blocks * n_split <= slots
        assert blocks * (n_split + 1) > slots or n_split == n_kv


def test_bf16_plan_is_the_default_of_the_generalised_planner():
    """The bf16 route's answers are the planner's defaults (64-row blocks,
    ``ATTN_TILE_K[D]``-key tiles, two blocks an SM)."""
    for (B, Hq, Hkv, Sq, Sk, D), _ in PLANS.values():
        assert ops.attention_splits(B, Hq, Sq, Sk, D, H100_SMS) == \
            ops.attention_splits(B, Hq, Sq, Sk, D, H100_SMS,
                                 ops.ATTN_BLOCK_Q, ops.ATTN_TILE_K[D], 2)


def _qkv(seed, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Hq, Sq, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, Hkv, Sk, D)) * 0.5).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    return q, k, v


def emulate_fp32_split(q, k, v, causal: bool, n_split: int, per: int):
    """The fp32 kernel's arithmetic in plain float32 on the host: for each
    64-row query block and each chunk of ``per`` 32-key tiles (cut where the
    kernel cuts them, up to the block's last causally visible tile), an
    online softmax tile by tile -- scores scaled after the product, masked
    to -1e30, ``m_use = 0`` while a row has seen no key, ``alpha`` rescaling
    the accumulator and l.  Returns the chunks' (acc, m, l) as the kernel
    writes them to its workspace; an empty chunk leaves acc = 0, m = -1e30,
    l = 0."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kf, vf = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (k, v))
    bq, bk = ops.ATTN_FP32_BLOCK_Q, ops.ATTN_FP32_TILE_K
    scale = 1.0 / D ** 0.5
    n_kv = -(-Sk // bk)
    acc = torch.zeros((n_split, B, Hq, Sq, D))
    m = torch.full((n_split, B, Hq, Sq), MASKED)
    den = torch.zeros((n_split, B, Hq, Sq))
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        qi = torch.arange(q0, q1)
        n_tiles = n_kv if not causal else min(
            n_kv, (q1 - 1 + Sk - Sq) // bk + 1)
        for z in range(n_split):
            a = torch.zeros((B, Hq, q1 - q0, D))
            mr = torch.full((B, Hq, q1 - q0), MASKED)
            lr = torch.zeros((B, Hq, q1 - q0))
            for t in range(z * per, min(n_tiles, (z + 1) * per)):
                keys = torch.arange(t * bk, min((t + 1) * bk, Sk))
                s = ref.matmul_f32(q[:, :, q0:q1],
                                   kf[:, :, keys].transpose(-1, -2)) * scale
                if causal:
                    s = torch.where(keys[None] <= qi[:, None] + (Sk - Sq), s,
                                    MASKED)
                m_new = torch.maximum(mr, s.amax(dim=-1))
                alpha = torch.exp(mr - m_new)
                m_use = torch.where(m_new == MASKED, 0.0, m_new)
                p = torch.exp(s - m_use[..., None])
                lr = lr * alpha + p.sum(dim=-1)
                a = a * alpha[..., None] + ref.matmul_f32(p, vf[:, :, keys])
                mr = m_new
            acc[z, :, :, q0:q1], m[z, :, :, q0:q1] = a, mr
            den[z, :, :, q0:q1] = lr
    return acc, m, den


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", [(1, 2, 2, 128, 640, 64),
                                  (2, 4, 2, 128, 384, 128)],
                         ids=["decode", "gqa"])
def test_fp32_split_emulation_matches_reference(R, dims, causal):
    """The planned split on 132 SMs, emulated and merged, equals the JAX
    reference.  At the causal decode shape (20 chunks of one tile) the last
    chunks see no key of the first rows, which the merge weighs by 0."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(sum(dims), *dims))
    n_split, per = _plan(*dims)
    assert n_split > 1
    acc, m, den = emulate_fp32_split(q, k, v, causal, n_split, per)
    if causal and dims[0] == 1:
        assert (n_split, per) == (20, 1)
        assert bool((den[:, :, :, :64] == 0).any())
        assert bool((m[den == 0] == MASKED).all())
    got = ref.merge_attention_partials(acc, m, den, out_dtype=torch.float32)
    want = R.ops.flash_attention(
        *(R.jnp.asarray(x.numpy()) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _cuda_qkv(dev, B, Hq, Hkv, Sq, Sk, D):
    return tuple(torch.from_numpy(x).to(dev)
                 for x in _qkv(Sq + Sk, B, Hq, Hkv, Sq, Sk, D))


SPLIT_DIMS = [PLANS["one-token decode"][0], PLANS["ragged, D = 256"][0],
              PLANS["timed"][0]]


@pytest.mark.cuda
@pytest.mark.parametrize("dims", SPLIT_DIMS)
def test_cuda_fp32_split_launches_the_kernel_and_the_merge(cuda_device, dims):
    """At the split shapes the fp32 route plans a split on the card and
    runs two device kernels a call: the attention kernel and the merge."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _cuda_qkv(cuda_device, *dims)
    assert ops.attention_launch_splits(q, k)[0] > 1
    ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    before = dict(ops.flash_attention.launches_by_route)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("flash_fp32_kernel" in n for n in names) == 1, names
    assert sum("merge_kernel" in n for n in names) == 1, names
    assert len(names) == 2, names
    assert ops.flash_attention.launches_by_route["fp32"] == before["fp32"] + 1
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", SPLIT_DIMS + [PLANS["starcoder2-3b chunked "
                                                     "decode"][0]])
def test_cuda_fp32_two_launches_same_bits(cuda_device, dims, causal):
    q, k, v = _cuda_qkv(cuda_device, *dims)
    first = ops.flash_attention(q, k, v, causal=causal)
    assert torch.equal(first, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.cuda
def test_cuda_fp32_misaligned_view_raises(cuda_device):
    B, Hq, Hkv, Sq, Sk, D = 1, 2, 2, 64, 64, 64
    n = B * Hq * Sq * D
    q = torch.zeros(n + 1, device=cuda_device)[1:].view(B, Hq, Sq, D)
    k = torch.zeros((B, Hkv, Sk, D), device=cuda_device)
    assert q.is_contiguous() and q.data_ptr() % 16
    before = ops.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned fp32"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="16-byte aligned fp32"):
        ops.flash_attention(k, q.view(B, Hkv, Sk, D), k)
    assert ops.flash_attention.launches == before

"""block_spmm's fp32 route: the host's split-K planner and the CPU path.

The planner (``ops.spmm_fp32_plan``) is plain Python: how K is cut into
ranges of whole 32-deep slabs, how many blocks the grid holds against the
card's resident slots, and the size of the partials' workspace.  The CUDA
kernel that follows the plan runs only on the card (``chip_smoke.py``
phases 2 and 8, ``test_torch_kernels.py::test_cuda_fp32_route``); here the
wrapper takes its plain version, which must equal the reference's
``block_spmm`` at the shapes the card splits.
"""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

H100_SMS = 132
BK = ops.SPMM_FP32_TILE[2]
# SAGE's aggregation over phase 8's views: (S, K, N) and the planned splits
ROOT_POST = (13440, 13440, 128)
KNOWS2 = (2048, 2048, 128)
SPLIT_SHAPES = [(64, 8192, 128), (100, 9000, 150), (37, 8195, 61)]
SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.fixture(scope="module")
def R():
    """The JAX reference's kernel wrappers and oracles."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as r_ops
    from repro.kernels import ref as r_ref
    return SimpleNamespace(jnp=jnp, ops=r_ops, ref=r_ref)


@pytest.mark.parametrize("K", [0, 1, 31, 32, 33, 64, 100, 2048, 8195, 13440])
@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 16])
def test_k_ranges_cover_k_once_in_order(K, n_split):
    n_slabs = -(-K // BK)
    n_split = max(1, min(n_split, n_slabs))
    ranges = ops.spmm_fp32_k_ranges(K, n_split)
    assert len(ranges) == n_split
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0                         # in order, no gap or overlap
    for k0, k1 in ranges:
        assert k0 % BK == 0                     # whole slabs
        assert k1 > k0 or K == 0                # no empty split
    lengths = [-(-(k1 - k0) // BK) for k0, k1 in ranges]
    assert max(lengths) - min(lengths) <= 1     # shared evenly


@pytest.mark.parametrize("blocks_per_sm", [1, 2])
@pytest.mark.parametrize("shape", [ROOT_POST, KNOWS2, *SPLIT_SHAPES,
                                   (8, 16, 12), (128, 128, 128),
                                   (256, 384, 128), (0, 5, 7), (9, 0, 4)])
def test_plan_splits_cover_k_and_size_the_workspace(shape, blocks_per_sm):
    S, K, N = shape
    plan = ops.spmm_fp32_plan(S, K, N, H100_SMS, blocks_per_sm)
    assert plan.grid == (-(-S // 128), -(-N // 128), plan.n_split)
    assert plan.slots == H100_SMS * blocks_per_sm
    blocks = plan.grid[0] * plan.grid[1] * plan.n_split
    assert plan.waves == -(-blocks // plan.slots)
    assert plan.workspace == (plan.n_split * S * N if plan.n_split > 1
                              else 0)
    ranges = ops.spmm_fp32_k_ranges(K, plan.n_split)
    assert [r for r in ranges if r[1] > r[0]] == ranges or K == 0
    assert sum(k1 - k0 for k0, k1 in ranges) == K
    if plan.n_split > 1:                       # at least two slabs a split
        assert min(k1 - k0 for k0, k1 in ranges) > BK


@pytest.mark.parametrize("blocks_per_sm, shape, n_split", [
    (1, ROOT_POST, 5), (1, KNOWS2, 8), (2, ROOT_POST, 5), (2, KNOWS2, 16)])
def test_plan_fills_the_card_at_sages_shapes(blocks_per_sm, shape, n_split):
    """With the kernel's one block an SM: 105 x 5 blocks in four waves of
    132 at ROOT_POST (99.4%), 16 x 8 in one at KNOWS2 (97%: 16 x 9 would
    take a second wave); with two an SM, two waves of 264 and one.  The
    slots of every wave the blocks take are at least 95% full, so no more
    than 5% of the SMs wait on any wave."""
    plan = ops.spmm_fp32_plan(*shape, H100_SMS, blocks_per_sm)
    blocks = plan.grid[0] * plan.grid[1] * plan.n_split
    assert plan.n_split == n_split
    assert blocks >= 0.95 * plan.slots
    assert blocks / (plan.waves * plan.slots) >= 0.95


@pytest.mark.parametrize("shape", [(128 * 264, 64, 128), (256, 27264, 27264),
                                   (13440, 13440, 27264)])
def test_one_split_when_the_tiles_fill_the_card(shape):
    plan = ops.spmm_fp32_plan(*shape, H100_SMS, 2)
    assert plan.grid[0] * plan.grid[1] >= plan.slots
    assert plan.n_split == 1 and plan.workspace == 0


def test_no_split_below_two_slabs_a_split():
    for K in (0, 1, 32, 64, 65, 127):
        assert ops.spmm_fp32_plan(1, K, 1, H100_SMS, 2).n_split <= max(
            1, -(-K // BK) // 2)


@pytest.mark.parametrize("semiring", ["count", "bool"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES[:2])
def test_cpu_path_matches_the_reference_at_split_shapes(R, shape, semiring):
    """The wrapper's CPU path against the reference's Pallas ``block_spmm``
    (interpret mode) and its oracle, bit for bit on integer values."""
    S, K, N = shape
    rng = np.random.default_rng(S + K)
    F = rng.integers(0, 3, (S, K)).astype(np.float32)
    A = (rng.random((K, N)) < 0.2).astype(np.float32)
    mask = rng.integers(0, 2, N).astype(np.float32)
    counting = semiring == "count"
    got = ops.block_spmm(torch.from_numpy(F), torch.from_numpy(A),
                         torch.from_numpy(mask), counting=counting)
    jF, jA, jm = (R.jnp.asarray(x) for x in (F, A, mask))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(R.ops.block_spmm(jF, jA, jm,
                                                 counting=counting)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(R.ref.block_spmm_ref(jF, jA, jm,
                                                     semiring=semiring)))


def test_smoke_split_checks_rehearse_on_cpu():
    """Phase 2's fp32 split cases run on the host through the plain
    version (no plan is asked for without a card)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.FP32_SPLIT_SHAPES == SPLIT_SHAPES
    before = ops.block_spmm.launches
    out = smoke.spmm_fp32_split_checks(ops, ref, torch.device("cpu"),
                                       np.random.default_rng(0))
    assert out == {"cases": len(SPLIT_SHAPES) * 4 * 5 * 2, "n_split": {}}
    assert ops.block_spmm.launches == before

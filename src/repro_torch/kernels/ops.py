"""Public wrappers around the hand-written CUDA kernels.

A wrapper takes the plain version (``ref.py``) only when its tensors lie on
the CPU.  For CUDA tensors it launches the kernel or raises — there is no
fallback.  Each wrapper counts its launches in an integer attribute
(``block_spmm.launches``, ``spmm_slab_map.launches``,
``segment_multi_agg.launches``, ``flash_attention.launches``) so a run can show that the main path went
through the kernel.  ``block_spmm`` and ``flash_attention`` pick a route by
dtype and count it in ``launches_by_route``: ``"tc"`` for the tensor cores
(u8 for integer hops, bf16 for attention), ``"fp32"`` for the CUDA-core
kernel that float32 operands keep.  ``spmm_slab_map`` lists the slabs of
an integer A that the ``tc`` route walks.  ``bucketize_messages`` is the
host-free layout step that feeds ``segment_multi_agg``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.utils import trace

# dtype codes of csrc/block_spmm.cu (enum DType)
_DT = {torch.int32: 0, torch.uint8: 1, torch.float32: 2}
_F_TYPES = (torch.int32, torch.uint8, torch.bool, torch.float32)
_A_TYPES = (torch.int32, torch.float32)
_OUT_TYPES = (torch.float32, torch.int32, torch.uint8)
# output rows, output columns and K slab of a block of the u8 kernel
SPMM_TILE = (256, 128, 64)
# the same of the fp32 kernel
SPMM_FP32_TILE = (128, 128, 32)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _sm_count(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _spmm_fns():
    from repro_torch.kernels.build import load
    lib = load("block_spmm")
    u8 = lib.block_spmm_u8_launch
    u8.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    smap = lib.block_spmm_slab_map_launch
    smap.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     *[ctypes.c_void_p] * 4]
    f32 = lib.block_spmm_fp32_launch
    f32.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    *[ctypes.c_int] * 6, ctypes.c_void_p, ctypes.c_void_p]
    occ = lib.block_spmm_fp32_blocks_per_sm
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int)]
    for fn in (u8, smap, f32, occ):
        fn.restype = ctypes.c_int
    return {"tc": u8, "slab_map": smap, "fp32": f32,
            "fp32_blocks_per_sm": occ}


_slow_slabs: Dict[torch.device, torch.Tensor] = {}


def spmm_slow_slabs(device) -> torch.Tensor:
    """The device's int64 count of (block, K slab) pairs that
    ``block_spmm``'s u8 route ran on the CUDA cores because a value of the
    slab lay outside 0..255.  Launches add to it on the card without a
    sync; reading it syncs, ``.zero_()`` resets it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    counter = _slow_slabs.get(dev)
    if counter is None:
        counter = torch.zeros((), dtype=torch.int64, device=dev)
        _slow_slabs[dev] = counter
    return counter


class SlabMap:
    """Which K slabs of an integer A [K, N] each column block of the u8
    route walks: the tiles of ``SPMM_TILE``'s 64 rows by 128 columns that
    hold a non-zero.  ``slabs`` int16 [n_colblocks, n_slabs] lists each
    column block's live slabs in ascending order (then -1), ``counts`` int32
    [n_colblocks] their number; both stay on A's device."""

    __slots__ = ("slabs", "counts", "shape", "_live")

    def __init__(self, slabs: torch.Tensor, counts: torch.Tensor,
                 shape: Tuple[int, int]):
        self.slabs, self.counts, self.shape = slabs, counts, shape
        self._live: Optional[int] = None

    def read_live(self) -> int:
        """The number of live tiles; the first call on a CUDA map syncs."""
        if self._live is None:
            self._live = int(self.counts.sum())
        return self._live

    @property
    def tiles(self) -> int:
        """Tiles of A, live or not."""
        return self.slabs.shape[0] * self.slabs.shape[1]


def spmm_slab_map(A: torch.Tensor) -> SlabMap:
    """The slab map of an int32 A, built on A's device with no host sync:
    ``spmm_slab_map_kernel`` reads A once and marks its live tiles,
    ``spmm_slab_list_kernel`` lists them.  The plain version on the CPU
    (``ref.spmm_slab_map_ref``).  A must not change while the map is in use:
    a cached adjacency, never written in place, carries its own."""
    if A.dim() != 2 or A.dtype != torch.int32:
        raise TypeError(f"spmm_slab_map takes an int32 [K, N] A, got "
                        f"{A.dtype} {tuple(A.shape)}")
    _, bn, bk = SPMM_TILE
    K, N = A.shape
    n_slabs, n_cb = _cdiv(K, bk), _cdiv(N, bn)
    if n_slabs > 2 ** 15 - 1:
        raise ValueError(f"spmm_slab_map lists slabs as int16: K = {K} "
                         f"has {n_slabs} slabs of {bk}")
    dev = A.device
    if dev.type == "cpu":
        return SlabMap(*ref.spmm_slab_map_ref(A, bk, bn), (K, N))
    if dev.type != "cuda":
        raise ValueError(f"spmm_slab_map runs on cpu or cuda, not {dev.type}")
    if not A.is_contiguous():
        raise ValueError("spmm_slab_map needs a contiguous row-major A")
    live = torch.empty(n_cb * n_slabs, dtype=torch.uint8, device=dev)
    slabs = torch.empty((n_cb, n_slabs), dtype=torch.int16, device=dev)
    counts = torch.empty(n_cb, dtype=torch.int32, device=dev)
    rc = _spmm_fns()["slab_map"](A.data_ptr(), K, N, live.data_ptr(),
                                 slabs.data_ptr(), counts.data_ptr(),
                                 _stream(dev))
    if rc != 0:
        raise RuntimeError(f"block_spmm slab map launch failed: CUDA error "
                           f"{rc}")
    spmm_slab_map.launches += 1
    return SlabMap(slabs, counts, (K, N))


spmm_slab_map.launches = 0


class Fp32Plan(NamedTuple):
    """How ``block_spmm``'s fp32 kernel covers one product."""
    n_split: int                   #: ranges of K (1: no partials)
    grid: Tuple[int, int, int]     #: (row tiles, column tiles, n_split)
    slots: int                     #: blocks the card holds at once
    waves: int                     #: ceil(blocks / slots)
    workspace: int                 #: fp32 elements of the partials


def spmm_fp32_k_ranges(K: int, n_split: int) -> List[Tuple[int, int]]:
    """The ``[k0, k1)`` of each split, in order: K's 32-deep slabs shared
    evenly, the first ``n_slabs % n_split`` splits one slab longer (the
    kernel's own rule, ``spmm_fp32_kernel``)."""
    bk = SPMM_FP32_TILE[2]
    n_slabs = _cdiv(K, bk)
    base, rem = divmod(n_slabs, n_split)
    ranges = []
    for z in range(n_split):
        k0 = (z * base + min(z, rem)) * bk
        ranges.append((k0, min(k0 + (base + (z < rem)) * bk, K)))
    return ranges


@functools.lru_cache(maxsize=1024)
def spmm_fp32_plan(S: int, K: int, N: int, n_sms: int,
                   blocks_per_sm: int) -> Fp32Plan:
    """Split-K plan of the fp32 kernel on a card of ``n_sms`` SMs that
    each hold ``blocks_per_sm`` of its blocks.

    When the 128 x 128 output tiles alone fill every slot, one split: the
    kernel writes the output.  Otherwise the split count, at most one per
    two 32-deep slabs, minimises an estimate in slab times of one block
    (128 x 128 x 32 FMAs): ``waves * (longest split + 1)``, the one for a
    slab in flight before the first, plus for a split
    ``1 + n_split * S * N / 2**21``, the pass that adds the partials
    (taken as 2^21 fp32 elements a slab time); the fewest splits on a tie.
    With the kernel's one block an SM on 132 SMs, 105 x 5 blocks fill four
    waves (99.4%) at ROOT_POST's 13,440 x 13,440 x 128 and 16 x 8 one wave
    (97%) at KNOWS2's 2,048 x 2,048 x 128, the fastest of the split counts
    timed there (``tools/spmm_fp32_ab.py --sweep``).  Each split then
    writes an fp32 partial ``[S, N]`` into a workspace of
    ``n_split * S * N`` elements.
    """
    bm, bn, bk = SPMM_FP32_TILE
    tiles = _cdiv(S, bm) * _cdiv(N, bn)
    slots = n_sms * blocks_per_sm
    n_slabs = _cdiv(K, bk)

    def cost(s: int) -> float:
        finish = 1 + s * S * N / 2 ** 21 if s > 1 else 0
        return _cdiv(tiles * s, slots) * (_cdiv(n_slabs, s) + 1) + finish

    n_split = 1
    if 0 < tiles < slots:
        n_split = min(range(1, min(n_slabs // 2, slots) + 1), key=cost,
                      default=1)
    return Fp32Plan(n_split, (_cdiv(S, bm), _cdiv(N, bn), n_split), slots,
                    _cdiv(tiles * n_split, slots),
                    n_split * S * N if n_split > 1 else 0)


@functools.lru_cache(maxsize=None)
def spmm_fp32_blocks_per_sm(index: Optional[int], f_dtype: torch.dtype,
                            a_dtype: torch.dtype,
                            out_dtype: torch.dtype) -> int:
    """Blocks of the fp32 kernel one SM of card ``index`` holds at once
    (the CUDA occupancy calculator, for these operand types)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):      # the query reads the current card
        rc = _spmm_fns()["fp32_blocks_per_sm"](
            _DT[f_dtype], _DT[a_dtype], _DT[out_dtype],
            ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"block_spmm fp32 occupancy query failed: CUDA "
                           f"error {rc}, {blocks.value} blocks an SM")
    return blocks.value


def spmm_fp32_launch_plan(F: torch.Tensor, A: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32
                          ) -> Fp32Plan:
    """The plan ``block_spmm`` takes for CUDA operands on its fp32 route."""
    dev = F.device
    f_dtype = torch.uint8 if F.dtype == torch.bool else F.dtype
    return spmm_fp32_plan(
        F.shape[0], F.shape[1], A.shape[1], _sm_count(dev.index),
        spmm_fp32_blocks_per_sm(dev.index, f_dtype, A.dtype, out_dtype))


def block_spmm(F: torch.Tensor, A: torch.Tensor,
               col_mask: Optional[torch.Tensor] = None, *,
               counting: bool = True,
               out_dtype: torch.dtype = torch.float32,
               slab_map: Optional[SlabMap] = None) -> torch.Tensor:
    """``semiring(F @ A) * col_mask`` — one frontier hop over a dense adjacency.

    F: [S, K] frontier (int32, bool/uint8 or float32), A: [K, N] adjacency
    (int32 or float32), col_mask: optional [N] destination mask.  Returns
    [S, N] in ``out_dtype`` (float32, int32, or uint8 for the bool semiring).
    Integer outputs are exact while walk counts stay below 2^24.  Integer
    F and A take the u8 tensor-core route (exact; a K slab holding a value
    outside 0..255 runs on the CUDA cores, see ``spmm_slow_slabs``), which
    walks only the slabs ``slab_map`` (A's ``spmm_slab_map``) lists, built
    here when none is given; the plain version on the CPU takes none.  A
    float32 operand takes the fp32 route: IEEE fp32 products on the CUDA
    cores (no TF32), K split over the card's SMs when the output tiles
    are few (``spmm_fp32_plan``), each split's fp32 partial written into a
    workspace allocated here on the caller's stream and added in split
    order by a second kernel, so two launches give the same bits; the
    sum's order, and only that, differs from the plain version's.
    """
    if F.dim() != 2 or A.dim() != 2 or F.shape[1] != A.shape[0]:
        raise ValueError(f"block_spmm shapes F{tuple(F.shape)} @ "
                         f"A{tuple(A.shape)} do not chain")
    S, K = F.shape
    N = A.shape[1]
    if col_mask is not None and tuple(col_mask.shape) != (N,):
        raise ValueError(f"col_mask shape {tuple(col_mask.shape)} != ({N},)")
    if slab_map is not None and slab_map.shape != (K, N):
        raise ValueError(f"slab_map of A{slab_map.shape} for A{(K, N)}")
    if out_dtype not in _OUT_TYPES or (counting and out_dtype == torch.uint8):
        raise ValueError(f"unsupported out_dtype {out_dtype} "
                         f"(counting={counting})")
    devices = {F.device, A.device} | (
        {col_mask.device} if col_mask is not None else set())
    if len(devices) != 1:
        raise ValueError(f"block_spmm operands on several devices: {devices}")
    dev = F.device
    if dev.type == "cpu":
        out = ref.block_spmm_ref(F, A, col_mask,
                                 semiring="count" if counting else "bool")
        return out.to(out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"block_spmm runs on cpu or cuda, not {dev.type}")
    if F.dtype not in _F_TYPES or A.dtype not in _A_TYPES:
        raise TypeError(f"block_spmm takes F in {_F_TYPES} and A in "
                        f"{_A_TYPES}, got {F.dtype} and {A.dtype}")
    if not (F.is_contiguous() and A.is_contiguous()):
        raise ValueError("block_spmm needs contiguous row-major F and A")
    if F.dtype == torch.bool:
        F = F.view(torch.uint8)
    mask = None
    if col_mask is not None:
        mask = col_mask.to(torch.float32).contiguous()
    out = torch.empty((S, N), dtype=out_dtype, device=dev)
    route = "fp32" if torch.float32 in (F.dtype, A.dtype) else "tc"
    common = (mask.data_ptr() if mask is not None else None, out.data_ptr(),
              _DT[out_dtype], S, K, N, 0 if counting else 1)
    bm, bn, bk = SPMM_TILE
    if route == "tc":
        if slab_map is None:
            slab_map = spmm_slab_map(A)
        elif slab_map.counts.device != dev:
            raise ValueError(f"slab_map on {slab_map.counts.device} for A "
                             f"on {dev}")
        f8 = flags = None
        if F.dtype == torch.int32:
            # the kernel's u8 copy of F, and a range flag per 128 x 64 region
            f8 = torch.empty((S, K), dtype=torch.uint8, device=dev)
            flags = torch.empty(_cdiv(S, 128) * _cdiv(K, bk),
                                dtype=torch.int32, device=dev)
        rc = _spmm_fns()["tc"](
            F.data_ptr(), _DT[F.dtype], A.data_ptr(),
            slab_map.slabs.data_ptr(), slab_map.counts.data_ptr(), *common,
            f8.data_ptr() if f8 is not None else None,
            flags.data_ptr() if flags is not None else None,
            spmm_slow_slabs(dev).data_ptr(), _stream(dev))
    else:
        plan = spmm_fp32_launch_plan(F, A, out_dtype)
        # the partials live on the caller's stream until the second kernel,
        # launched on it in the same call, has read them
        ws = (torch.empty(plan.workspace, dtype=torch.float32, device=dev)
              if plan.n_split > 1 else None)
        rc = _spmm_fns()["fp32"](F.data_ptr(), _DT[F.dtype], A.data_ptr(),
                                 _DT[A.dtype], *common, plan.n_split,
                                 ws.data_ptr() if ws is not None else None,
                                 _stream(dev))
    if rc != 0:
        raise RuntimeError(f"block_spmm {route} launch failed: CUDA error "
                           f"{rc}")
    block_spmm.launches += 1
    block_spmm.launches_by_route[route] += 1
    if route == "tc":
        if trace.on():
            # the (block, K slab) pairs walked and those a dense A has; the
            # live total is read when the record is, not now: a read here
            # would wait for the work queued before the map
            row_tiles = _cdiv(S, bm)
            trace.add_later("spmm_live_slabs",
                            lambda: row_tiles * slab_map.read_live())
            trace.add("spmm_dense_slabs", row_tiles * slab_map.tiles)
    return out


block_spmm.launches = 0
block_spmm.launches_by_route = {"tc": 0, "fp32": 0}


# ---------------------------------------------------------------------------
# segment_multi_agg
# ---------------------------------------------------------------------------

# dtype codes of csrc/segment_agg.cu; the float types flash_attention takes
_FLOAT_DT = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _agg_fn():
    from repro_torch.kernels.build import load
    fn = load("segment_agg").segment_agg_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   *[ctypes.c_void_p] * 4, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bucketize_messages(dst, msg: torch.Tensor, num_nodes: int,
                       width: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ELL bucketing of per-edge messages by destination, on ``msg``'s device.

    dst: [E] destination of each edge, msg: [E, D].  Slot ``k`` of node
    ``d`` holds the ``k``-th edge (in edge order) whose destination is
    ``d``; edges past the width are dropped.  The width is
    ``int(width or max(max_in_degree, 1))``.  Returns (bucketed [N, W, D]
    in ``msg.dtype``, valid [N, W] bool): the layout ``segment_multi_agg``
    reads.  A stable sort of ``dst`` and a rank within each segment replace
    the reference's per-edge loop; one scatter writes the slots.
    """
    msg = torch.as_tensor(msg)
    dev = msg.device
    dst = torch.as_tensor(dst, device=dev).to(torch.int64)
    if dst.dim() != 1 or msg.dim() != 2 or msg.shape[0] != dst.shape[0]:
        raise ValueError(f"bucketize_messages takes dst [E] and msg [E, D], "
                         f"got {tuple(dst.shape)} and {tuple(msg.shape)}")
    deg = torch.bincount(dst, minlength=num_nodes)
    if deg.shape[0] != num_nodes:
        raise ValueError(f"a destination is not below num_nodes={num_nodes}")
    W = int(width or max(int(deg.max()) if num_nodes else 0, 1))
    order = torch.argsort(dst, stable=True)
    sdst = dst[order]
    start = torch.cumsum(deg, 0) - deg
    rank = torch.arange(dst.shape[0], device=dev) - start[sdst]
    keep = rank < W
    rows, slots = sdst[keep], rank[keep]
    out = torch.zeros((num_nodes, W, msg.shape[1]), dtype=msg.dtype,
                      device=dev)
    out[rows, slots] = msg[order[keep]]
    valid = torch.zeros((num_nodes, W), dtype=torch.bool, device=dev)
    valid[rows, slots] = True
    return out, valid


def segment_multi_agg(msg: torch.Tensor, valid: torch.Tensor, *,
                      eps: float = 1e-5) -> Tuple[torch.Tensor, ...]:
    """Fused (mean, max, min, std) over bucketed neighbour messages.

    msg: [N, W, D] float32 or bfloat16, valid: [N, W] bool or uint8.
    Returns four float32 [N, D] tensors, views of one [4, N, D] tensor;
    ``std = sqrt(max(E[x²] - mean², 0) + eps)`` and rows with no valid slot
    give 0.  A NaN of a valid slot reaches all four outputs of its column.
    Invalid slots must hold finite values, as ``bucketize_messages`` leaves
    them: the kernel never reads them, while the reference (and the plain
    version on the CPU) multiplies them by 0 for the mean and std.  Ragged
    N and D need no padding.
    """
    if msg.dim() != 3 or valid.dim() != 2 or \
            tuple(valid.shape) != tuple(msg.shape[:2]):
        raise ValueError(f"segment_multi_agg takes msg [N, W, D] and valid "
                         f"[N, W], got {tuple(msg.shape)} and "
                         f"{tuple(valid.shape)}")
    if msg.dtype not in _FLOAT_DT or valid.dtype not in (torch.bool,
                                                         torch.uint8):
        raise TypeError(f"segment_multi_agg takes float32/bfloat16 msg and "
                        f"bool/uint8 valid, got {msg.dtype}, {valid.dtype}")
    if msg.device != valid.device:
        raise ValueError(f"segment_multi_agg operands on several devices: "
                         f"{msg.device}, {valid.device}")
    dev = msg.device
    if dev.type == "cpu":
        return ref.segment_multi_agg_ref(msg.to(torch.float32), valid, eps)
    if dev.type != "cuda":
        raise ValueError(f"segment_multi_agg runs on cpu or cuda, "
                         f"not {dev.type}")
    if not (msg.is_contiguous() and valid.is_contiguous()):
        raise ValueError("segment_multi_agg needs contiguous msg and valid")
    N, W, D = msg.shape
    out = torch.empty((4, N, D), dtype=torch.float32, device=dev)
    ptr, step = out.data_ptr(), N * D * 4
    rc = _agg_fn()(
        msg.data_ptr(), _FLOAT_DT[msg.dtype], valid.data_ptr(), ptr,
        ptr + step, ptr + 2 * step, ptr + 3 * step, N, W, D, eps,
        _stream(dev))
    if rc != 0:
        raise RuntimeError(f"segment_multi_agg launch failed: CUDA error {rc}")
    segment_multi_agg.launches += 1
    return out.unbind(0)


segment_multi_agg.launches = 0


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

HEAD_DIMS = (64, 128, 256)


#: query rows of a block and keys of a kv tile of the bf16 kernel, by D
ATTN_BLOCK_Q = 64
ATTN_TILE_K = {64: 64, 128: 64, 256: 32}
#: the same of the fp32 kernel, at every D
ATTN_FP32_BLOCK_Q = 64
ATTN_FP32_TILE_K = 32


@functools.lru_cache(maxsize=None)
def _flash_fns():
    from repro_torch.kernels.build import load
    lib = load("flash_attention")
    f32 = lib.flash_attention_fp32_launch
    tc = lib.flash_attention_bf16_launch
    for fn in (f32, tc):
        fn.argtypes = [*[ctypes.c_void_p] * 6, *[ctypes.c_int] * 9,
                       ctypes.c_void_p]
    occ = lib.flash_attention_fp32_blocks_per_sm
    occ.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for fn in (f32, tc, occ):
        fn.restype = ctypes.c_int
    return {"tc": tc, "fp32": f32, "fp32_blocks_per_sm": occ}


def attention_splits(B: int, Hq: int, Sq: int, Sk: int, D: int, n_sm: int,
                     block_q: int = ATTN_BLOCK_Q, tile_k: Optional[int] = None,
                     blocks_per_sm: int = 2,
                     one_wave: bool = False) -> Tuple[int, int]:
    """``(n_split, tiles_per_split)`` of a route's split over keys.

    ``block_q`` query rows a block and ``tile_k`` keys a kv tile are the
    route's (by default the bf16 kernel's: 64 and ``ATTN_TILE_K[D]``).
    When ``B * Hq * ceil(Sq / block_q)`` blocks leave SMs idle, each
    block's kv tiles are cut into chunks, at most one chunk per kv tile,
    for the card's ``n_sm * blocks_per_sm`` resident slots: by default
    (the bf16 route) at least that many blocks, about two an SM; with
    ``one_wave`` (the fp32 route, at its kernel's occupancy) the most that
    fit the slots at once, since a second wave of a few blocks would take
    as long as the first.  The last chunk may be shorter; none is empty
    for the last query tile.  ``(1, n_kv_tiles)`` means no split.
    """
    n_kv = max(_cdiv(Sk, tile_k or ATTN_TILE_K[D]), 1)
    blocks = B * Hq * _cdiv(Sq, block_q)
    if blocks == 0 or blocks >= n_sm:
        return 1, n_kv
    slots = blocks_per_sm * n_sm
    n_split = min(slots // blocks if one_wave else _cdiv(slots, blocks),
                  n_kv)
    per = _cdiv(n_kv, n_split)
    return _cdiv(n_kv, per), per


@functools.lru_cache(maxsize=None)
def attention_fp32_blocks_per_sm(index: Optional[int], D: int) -> int:
    """Blocks of the fp32 attention kernel at head_dim ``D`` that one SM of
    card ``index`` holds at once (the CUDA occupancy calculator)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):      # the query reads the current card
        rc = _flash_fns()["fp32_blocks_per_sm"](D, ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"flash_attention fp32 occupancy query failed: "
                           f"CUDA error {rc}, {blocks.value} blocks an SM")
    return blocks.value


def attention_launch_splits(q: torch.Tensor,
                            k: torch.Tensor) -> Tuple[int, int]:
    """The ``(n_split, tiles_per_split)`` that ``flash_attention`` takes for
    these CUDA operands: the bf16 route's rule, or the fp32 kernel's tiles
    in one wave at the occupancy its kernel reports on this card."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    index = q.device.index
    if q.dtype == torch.bfloat16:
        return attention_splits(B, Hq, Sq, Sk, D, _sm_count(index))
    return attention_splits(B, Hq, Sq, Sk, D, _sm_count(index),
                            ATTN_FP32_BLOCK_Q, ATTN_FP32_TILE_K,
                            attention_fp32_blocks_per_sm(index, D),
                            one_wave=True)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Fused attention forward with grouped KV heads.

    q: [B, Hq, Sq, D], k and v: [B, Hkv, Sk, D] with Hq a multiple of Hkv
    (query head h reads KV head h // (Hq/Hkv), no repeat), Sk >= Sq, D in
    64/128/256, all float32 or all bfloat16.  Scale 1/sqrt(D); the causal
    diagonal is shifted by Sk - Sq (chunked decode).  Returns [B, Hq, Sq, D]
    in ``q.dtype``.  bfloat16 runs on the tensor cores, float32 on the
    CUDA cores in IEEE fp32 (no TF32).  CUDA operands must be contiguous
    and 16-byte aligned.  When the query blocks are too few to fill the
    card, either route splits over keys (``attention_launch_splits``): the
    chunks' fp32 partials go to a workspace allocated here on the caller's
    stream, and a second kernel merges them in chunk order, so two launches
    give the same bits.
    """
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention takes q [B,Hq,Sq,D] and k, v "
                         f"[B,Hkv,Sk,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if Sk < Sq:
        raise ValueError(f"flash_attention needs Sk >= Sq, got Sk={Sk} "
                         f"Sq={Sq}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    if q.dtype not in _FLOAT_DT or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention operands on several devices")
    dev = q.device
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, "
                         f"not {dev.type}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    route = "tc" if q.dtype == torch.bfloat16 else "fp32"
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"flash_attention needs 16-byte aligned "
                         f"{'bf16' if route == 'tc' else 'fp32'} q, k and v")
    out = torch.empty_like(q)
    n_split, per = attention_launch_splits(q, k)
    ws_o = ws_ml = None
    if n_split > 1:
        # the partials live on the caller's stream until the merge,
        # launched on it in the same call, has read them
        rows = B * Hq * Sq
        ws_o = torch.empty((n_split, rows, D), dtype=torch.float32,
                           device=dev)
        ws_ml = torch.empty((2, n_split, rows), dtype=torch.float32,
                            device=dev)
    rc = _flash_fns()[route](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ws_o.data_ptr() if ws_o is not None else None,
        ws_ml.data_ptr() if ws_ml is not None else None,
        B, Hq, Hkv, Sq, Sk, D, int(causal), n_split, per, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"flash_attention {route} launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = {"tc": 0, "fp32": 0}

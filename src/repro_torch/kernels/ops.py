"""Public wrappers around the hand-written CUDA kernels.

A wrapper takes the plain version (``ref.py``) only when its tensors lie on
the CPU.  For CUDA tensors it launches the kernel or raises — there is no
fallback.  Each wrapper counts its launches in an integer attribute
(``block_spmm.launches``) so a run can show that the main path went
through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import ref

# dtype codes of csrc/block_spmm.cu (enum DType)
_DT = {torch.int32: 0, torch.uint8: 1, torch.float32: 2}
_F_TYPES = (torch.int32, torch.uint8, torch.bool, torch.float32)
_A_TYPES = (torch.int32, torch.float32)
_OUT_TYPES = (torch.float32, torch.int32, torch.uint8)


@functools.lru_cache(maxsize=None)
def _spmm_fn():
    from repro_torch.kernels.build import load
    fn = load("block_spmm").block_spmm_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def block_spmm(F: torch.Tensor, A: torch.Tensor,
               col_mask: Optional[torch.Tensor] = None, *,
               counting: bool = True,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``semiring(F @ A) * col_mask`` — one frontier hop over a dense adjacency.

    F: [S, K] frontier (int32, bool/uint8 or float32), A: [K, N] adjacency
    (int32 or float32), col_mask: optional [N] destination mask.  Returns
    [S, N] in ``out_dtype`` (float32, int32, or uint8 for the bool semiring).
    Integer outputs are exact while walk counts stay below 2^24.
    """
    if F.dim() != 2 or A.dim() != 2 or F.shape[1] != A.shape[0]:
        raise ValueError(f"block_spmm shapes F{tuple(F.shape)} @ "
                         f"A{tuple(A.shape)} do not chain")
    S, K = F.shape
    N = A.shape[1]
    if col_mask is not None and tuple(col_mask.shape) != (N,):
        raise ValueError(f"col_mask shape {tuple(col_mask.shape)} != ({N},)")
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
    rc = _spmm_fn()(
        F.data_ptr(), _DT[F.dtype], A.data_ptr(), _DT[A.dtype],
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        _DT[out_dtype], S, K, N, 0 if counting else 1,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_spmm launch failed: CUDA error {rc}")
    block_spmm.launches += 1
    return out


block_spmm.launches = 0

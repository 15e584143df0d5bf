"""Device resolution and the device-to-host pulls.

Entry points run on the card unless the caller asks for the CPU: ``None``
resolves to ``cuda`` and raises when no CUDA device exists — there is no
silent fallback to the host.  Every read of device state into numpy goes
through :func:`host`, and every read of a scalar flag through
:func:`host_flag`, so host syncs are visible in one place: each counts its
calls (``host.calls``, ``host_flag.calls``), and while tracing is on
adds it to the innermost open span's ``pulls`` (``utils/trace.py``).
A large pull off the card lands in page-locked memory that
:func:`pinned_empty` takes from PyTorch's caching pinned-host allocator.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.utils import trace

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card; an explicit ``"cpu"`` is the only way to
    run on the host.  Raises when a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the host")
    return dev


def _pull(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pinned_empty(shape, dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, Optional[int]]:
    """An empty page-locked host tensor from PyTorch's caching pinned-host
    allocator, and, while tracing is on, the blocks the allocator had to
    create for it (0 when it reused a cached block; None untraced).  The
    allocator rounds a block up to a power of two and hands it out again
    only once the tensor and every view of it are gone."""
    if not trace.on():
        return torch.empty(shape, dtype=dtype, pin_memory=True), None
    n0 = torch.cuda.host_memory_stats()["num_host_alloc"]
    out = torch.empty(shape, dtype=dtype, pin_memory=True)
    return out, torch.cuda.host_memory_stats()["num_host_alloc"] - n0


def host(*xs, out: Optional[torch.Tensor] = None):
    """Device tensors (or array-likes) -> numpy: one array for one
    argument, a tuple for several.  One call is one counted pull: the
    first copy waits for the device, the rest of the call's copies find
    it idle.

    With ``out``, a host tensor of the first argument's shape and dtype
    (page-locked: :func:`pinned_empty`), the first argument is copied into
    it by one blocking ``copy_`` (one DMA and one wait for the stream, no
    event recorded) and comes back as ``out``'s own memory: the ndarray
    keeps ``out`` alive."""
    host.calls += 1
    trace.add("pulls", 1)
    got = ([_pull(x) for x in xs] if out is None else
           [out.copy_(xs[0]).numpy()] + [_pull(x) for x in xs[1:]])
    return got[0] if len(xs) == 1 else tuple(got)


def host_flag(x) -> bool:
    """A device scalar (a flag or a count) read as a Python bool, for the
    host to branch on; counted apart from :func:`host`."""
    host_flag.calls += 1
    trace.add("pulls", 1)
    if isinstance(x, torch.Tensor):
        return bool(x.item())
    return bool(x)


host.calls = 0
host_flag.calls = 0

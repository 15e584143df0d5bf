"""Device resolution and the one device-to-host pull.

Entry points run on the card unless the caller asks for the CPU: ``None``
resolves to ``cuda`` and raises when no CUDA device exists — there is no
silent fallback to the host.  Every read of device state into numpy goes
through :func:`host`, so host syncs are visible in one place.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

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


def host(x) -> np.ndarray:
    """Device tensor (or array-like) -> numpy, one copy per call."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

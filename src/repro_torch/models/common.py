"""Shared functional layers over parameter dictionaries.

The reference's layout is kept, so converting weights is a copy: a dense
layer is ``{"w": [d_in, d_out]}`` plus an optional ``"b": [d_out]``, and
``dense`` computes ``x @ w + b``.  Initialisation draws from an explicit
``torch.Generator`` on the host, so a seed gives the same weights on every
device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.utils import resolve_device
from repro_torch.utils.device import DeviceLike

Params = Dict[str, Any]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: Optional[float] = None, bias: bool = False,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    scale = scale if scale is not None else (1.0 / (d_in ** 0.5))
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype) * scale
    p = {"w": w.to(dev)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y

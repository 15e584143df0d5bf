"""The shard grid of a sharded session.

A sharded session is one process driving a list of devices: shard ``s``'s
tensors live on ``devices[s]``.  A list may name one device several times;
that is how more shards than cards run (on the CPU, or several logical
shards on one card), and it is only ever asked for explicitly.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def make_host_mesh(n_data: int = 1, n_model: int = 1,
                   devices: Optional[Sequence] = None) -> np.ndarray:
    """The ``(n_data, n_model)`` grid of ``torch.device`` s.

    ``devices`` overrides the device list (the first ``n_data * n_model``
    entries are taken); by default the visible cards ``cuda:0 …`` are.
    Raises a descriptive error when fewer devices exist than the grid
    needs — no grid folds several shards onto one device unless the list
    says so."""
    need = n_data * n_model
    if devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if len(devs) < need:
        raise ValueError(
            f"make_host_mesh needs {need} devices for a "
            f"({n_data} data x {n_model} model) mesh but only "
            f"{len(devs)} {'were passed' if devices is not None else 'are available'}"
            " — pass devices= (a list may name one device several times, "
            "e.g. ['cuda:0'] * n to run n shards on one card)")
    grid = np.empty(need, dtype=object)
    grid[:] = devs[:need]
    return grid.reshape(n_data, n_model)

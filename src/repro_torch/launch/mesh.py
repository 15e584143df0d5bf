"""Meshes: the shard grid of a sharded session, and the rank mesh of the
multi-device layer.

A sharded session (``make_host_mesh``) is one process driving a list of
devices: shard ``s``'s tensors live on ``devices[s]``.  A list may name one
device several times; that is how more shards than cards run (on the CPU,
or several logical shards on one card), and it is only ever asked for
explicitly.

A :class:`Mesh` is the reference's ``jax.sharding.Mesh`` for the layers
that exchange data halfway through (the ``shard_map`` bodies): one process
a rank, ranks laid out row-major over named axes, one ``torch.distributed``
group for every slice along an axis.  :func:`make_rank_mesh` builds it from
what the caller gives (world size, rank, ``tcp://localhost:<port>``, shape,
axis names, backend, devices); nothing is read from the environment.  A
mesh without ranks (:func:`make_production_mesh`) only carries its shape,
for the sharding rules.
"""
from __future__ import annotations

from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.utils.device import DeviceLike, resolve_device


class Mesh:
    """Named axes over ranks.  ``shape`` maps axis name to size, in order
    (as a jax mesh's ``shape``).  A rank mesh also knows its ``rank``, its
    ``device``, its ``backend`` and, for every axis, the group of the ranks
    that differ from it along that axis only (``groups``); ``counts``
    holds, for every collective, its calls, the bytes this rank handed to
    it (``bytes``; ``"staged"``: bytes copied through host memory for
    gloo) and the bytes of its output on this rank (``out_bytes``, what
    the reference's roofline sums over the collectives of its HLO);
    ``axis_out_bytes`` the output bytes by the axis they ran over.  A
    meta rank mesh (:func:`make_meta_mesh`, ``backend="meta"``) has no
    process group: its collectives take ``meta`` tensors and only count."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: Optional[int] = None,
                 device: Optional[torch.device] = None,
                 backend: Optional[str] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))
        self.rank, self.device, self.backend = rank, device, backend
        self.groups: Dict[str, object] = {}
        self.counts: Dict[str, Dict[str, int]] = {}
        self.axis_out_bytes: Dict[str, int] = {}

    @property
    def has_ranks(self) -> bool:
        return self.rank is not None

    def coords(self) -> Dict[str, int]:
        """This rank's index along every axis (row-major layout)."""
        idx = np.unravel_index(self.rank, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    @property
    def is_meta(self) -> bool:
        return self.backend == "meta"

    def count(self, name: str, nbytes: int, out_bytes: int = 0,
              axis: Optional[str] = None) -> None:
        rec = self.counts.setdefault(name, {"calls": 0, "bytes": 0,
                                            "out_bytes": 0})
        rec["calls"] += 1
        rec["bytes"] += int(nbytes)
        rec["out_bytes"] += int(out_bytes)
        if axis is not None:
            self.axis_out_bytes[axis] = (self.axis_out_bytes.get(axis, 0)
                                         + int(out_bytes))

    def reset_counts(self) -> None:
        self.counts = {}
        self.axis_out_bytes = {}

    def __repr__(self) -> str:
        where = "" if self.rank is None else \
            f", rank={self.rank}, device={self.device}, backend={self.backend}"
        return f"Mesh({self.shape}{where})"


def require_rank_mesh(mesh, what: str) -> Mesh:
    """``mesh`` if it is a rank mesh, else a ``TypeError`` naming ``what``."""
    if not isinstance(mesh, Mesh) or not mesh.has_ranks:
        raise TypeError(f"{what} needs a rank mesh from "
                        f"launch.mesh.make_rank_mesh, got {mesh!r}")
    return mesh


def _rank_devices(devices, world_size: int, backend: str
                  ) -> list:
    if devices is None:
        if backend == "nccl":
            return [torch.device("cuda", i) for i in range(world_size)]
        return [resolve_device(None)] * world_size
    if isinstance(devices, (str, torch.device)):
        return [torch.device(devices)] * world_size
    devs = [torch.device(d) for d in devices]
    if len(devs) != world_size:
        raise ValueError(f"{len(devs)} devices given for {world_size} ranks")
    return devs


def make_rank_mesh(world_size: int, rank: int, init_method: str,
                   shape: Sequence[int],
                   axis_names: Sequence[str] = ("data", "model"), *,
                   backend: str,
                   devices: Union[DeviceLike, Sequence[DeviceLike]] = None,
                   timeout_s: float = 300.0) -> Mesh:
    """Join the process group and build this rank's :class:`Mesh`.

    ``devices``: one device for every rank, or a list with each rank's
    (``None``: the card; with ``nccl``, card ``i`` for rank ``i``).
    ``backend`` is ``"nccl"`` (every rank on a card of its own) or
    ``"gloo"`` (any devices: the CPU, or several ranks on one card, its
    collectives staged through host memory).  Every rank must call this
    with the same arguments but ``rank``; it builds one group per axis
    slice, all ranks in the same order.  A process that has joined the
    group already builds another mesh over the same ranks."""
    import torch.distributed as dist
    mesh_size = int(np.prod(list(shape), dtype=np.int64))
    if mesh_size != world_size:
        raise ValueError(f"a mesh of shape {tuple(shape)} holds {mesh_size} "
                         f"ranks, not the world size {world_size}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: name 'nccl' or 'gloo'")
    devs = _rank_devices(devices, world_size, backend)
    if backend == "nccl":
        if any(d.type != "cuda" for d in devs):
            raise ValueError(f"nccl runs on CUDA devices only, got {devs}")
        seen: Dict[torch.device, int] = {}
        for r, d in enumerate(devs):
            if d in seen:
                raise ValueError(
                    f"nccl needs a card of its own for every rank: ranks "
                    f"{seen[d]} and {r} share {d}; name backend='gloo' to "
                    f"run several ranks on one card")
            seen[d] = r
    dev = devs[rank]
    if dev.type == "cuda":
        dev = resolve_device(dev)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if backend == "nccl":
            torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
    elif (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
        raise ValueError(f"this process is rank {dist.get_rank()} of "
                         f"{dist.get_world_size()} already, not {rank} of "
                         f"{world_size}")
    mesh = Mesh(shape, axis_names, rank, dev, backend)
    sizes = list(mesh.shape.values())
    grid = np.arange(world_size).reshape(sizes)
    for i, name in enumerate(mesh.axis_names):
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        for ranks in lines:
            group = dist.new_group([int(r) for r in ranks], backend=backend)
            if rank in ranks:
                mesh.groups[name] = group
    return mesh


def make_meta_mesh(shape: Sequence[int],
                   axis_names: Sequence[str] = ("data", "model"),
                   rank: int = 0) -> Mesh:
    """A rank mesh without processes, for counting: rank ``rank`` of a
    mesh of ``shape`` on the ``meta`` device.  Its collectives take
    ``meta`` tensors, return ``meta`` tensors of their outputs' shapes and
    count calls and bytes as a real mesh's do."""
    mesh = Mesh(shape, axis_names, rank, torch.device("meta"), "meta")
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} is outside a mesh of {mesh.size}")
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, shape only (no ranks): a 16 x 16
    pod, or 2 x 16 x 16 with a leading ``pod`` axis; for the sharding
    rules."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def data_axes(mesh) -> Tuple[str, ...]:
    """The batch-sharding axes: ('pod','data') on multi-pod, ('data',) else."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_product(mesh, axes: Sequence[str]) -> int:
    """The number of ranks along ``axes`` together."""
    return int(np.prod([mesh.shape[a] for a in axes], dtype=np.int64))


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

"""Checkpoint save/restore in the reference's format, async: the port of
``repro.train.checkpoint``.

A checkpoint is a directory ``step_XXXXXXXX`` holding ``arrays.npz`` (the
leaves as ``a0``, ``a1``, ... in sorted key order) and ``manifest.json``
(``{"step", "leaves": {key: {"file", "shape", "dtype"}}}``).  A leaf's key
is its path in the tree as the reference's ``jax.tree_util`` names it: a
dict key as itself, a list or tuple index as its number, a NamedTuple
field as ``.name``, joined by ``/`` (``.params/embed/table``,
``.opt_state/.step``, ``.opt_state/.m/embed/table/q``); ``None`` holds no
leaf.  So a checkpoint written by either package restores in the other.

numpy has no bfloat16: a bf16 leaf is written as its two raw bytes a value
(uint16) with ``"dtype": "bfloat16"`` in the manifest, and restored by
viewing them as ``torch.bfloat16``.  (The reference writes the same bytes
and the same dtype name, but cannot restore them: ``np.load`` gives
``|V2``.)  Saves copy to the host, so a checkpoint restores onto any
device: :func:`restore` puts each leaf where the matching leaf of its
``tree_like`` lives.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.common import tree_map

Params = Any
BF16 = "bfloat16"


def _flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{key: leaf} in traversal order, keys named as the reference's."""
    def join(k) -> str:
        return f"{prefix}/{k}" if prefix else str(k)

    if tree is None:
        return {}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten_with_paths(v, join(k)))
    return out


def _to_numpy(leaf):
    """(numpy array, manifest dtype) of a tensor or array on the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(tree: Params, directory: str, step: int, keep: int = 3) -> str:
    """Synchronous checkpoint save; returns the checkpoint path."""
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten_with_paths(tree)
    manifest = {"step": step, "leaves": {}}
    arrays = {}
    for i, (key, leaf) in enumerate(sorted(flat.items())):
        arr, dtype = _to_numpy(leaf)
        name = f"a{i}"
        arrays[name] = arr
        manifest["leaves"][key] = {"file": name, "shape": list(arr.shape),
                                   "dtype": dtype}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.isdir(path):  # re-save after restart overwrites
        shutil.rmtree(path)
    os.replace(tmp, path)  # atomic publish
    _gc(directory, keep)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.asarray(arr, order="C")
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(tree_like: Params, directory: str,
            step: Optional[int] = None) -> Params:
    """Restore into the structure of ``tree_like`` (values replaced, each
    leaf on the device of the leaf it replaces)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        keys = iter(_flatten_with_paths(tree_like))

        def load(like: torch.Tensor) -> torch.Tensor:
            meta = manifest["leaves"][next(keys)]
            return _from_numpy(data[meta["file"]], meta["dtype"]).to(
                like.device)

        return tree_map(load, tree_like)


def _gc(directory: str, keep: int) -> None:
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncSaver:
    """Fire-and-forget checkpointing on a background thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None
        self.error: Optional[BaseException] = None

    def save(self, tree: Params, directory: str, step: int, keep: int = 3):
        self.wait()
        # the copy to the host happens here, on the calling thread, before
        # the caller's next step can change the tensors in place; the
        # background thread only serializes
        host_tree = tree_map(lambda x: x.detach().to("cpu", copy=True), tree)

        def _run():
            try:
                self.last_path = save(host_tree, directory, step, keep)
            except BaseException as e:  # surfaced on next wait()
                self.error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err

"""Rebuild port state from plain arrays (no JAX involved).

A graph or schema described by numpy arrays and label lists — for example
the fields of a graph built by the reference package, pulled to the host —
becomes the port's :class:`~repro_torch.core.graph.PropertyGraph` /
:class:`~repro_torch.core.schema.GraphSchema`, so both packages can run on
identical state.  :func:`sage_params_from_arrays`,
:func:`pna_params_from_arrays`, :func:`transformer_params_from_arrays`,
:func:`dimenet_params_from_arrays`, :func:`nequip_params_from_arrays`,
:func:`mace_params_from_arrays` and :func:`mind_params_from_arrays` carry
model weights the same way, and :func:`train_state_from_arrays` a whole
train state: the layouts are the reference's, so each is a copy (bf16
weights cross as float32 arrays, numpy having no bf16, and are cast to
``dtype``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.graph import PropertyGraph
from repro_torch.core.schema import GraphSchema
from repro_torch.train.optimizer import AdamState
from repro_torch.train.trainer import TrainState
from repro_torch.utils import resolve_device
from repro_torch.utils.device import DeviceLike

_COLUMNS = {
    "node_label": np.int32, "node_key": np.int32, "node_alive": bool,
    "edge_src": np.int32, "edge_dst": np.int32, "edge_label": np.int32,
    "edge_alive": bool, "edge_weight": np.int32,
}


def graph_from_arrays(arrays: Dict[str, object],
                      device: DeviceLike = None) -> PropertyGraph:
    """``arrays`` maps each :class:`PropertyGraph` field name to a numpy
    array; ``node_props`` / ``edge_props`` map property names to int32
    columns."""
    dev = resolve_device(device)

    def put(a, dtype) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)  # a copy

    cols = {k: put(arrays[k], dt) for k, dt in _COLUMNS.items()}
    props = {kind: {name: put(col, np.int32)
                    for name, col in dict(arrays.get(kind, {})).items()}
             for kind in ("node_props", "edge_props")}
    return PropertyGraph(**cols, **props)


def schema_from_labels(node_labels: Sequence[str], edge_labels: Sequence[str],
                       view_labels: Iterable[str] = ()) -> GraphSchema:
    """A schema interning the labels in id order; ``view_labels`` (a subset
    of ``edge_labels``) are marked as view-owned."""
    schema = GraphSchema()
    for name in node_labels:
        schema.node_labels.intern(name)
    for name in edge_labels:
        schema.edge_labels.intern(name)
    for name in view_labels:
        schema.register_view_label(name)
    return schema


def sage_params_from_arrays(params: Mapping[str, Mapping[str, object]],
                            device: DeviceLike = None) -> Dict[str, Dict]:
    """SAGE parameters in the reference's names and layouts — ``{"enc":
    {"w", "b"}, "self0": {"w", "b"}, "nbr0": {"w"}, ..., "head": {"w",
    "b"}}`` of arrays, ``w`` as ``[d_in, d_out]`` — as the port's float32
    parameter dictionary on ``device``.  The layouts are the same, so this
    is a copy."""
    return _tree_from_arrays(params, torch.float32, resolve_device(device))


def _tree_from_arrays(tree, dtype: torch.dtype, dev: torch.device):
    if isinstance(tree, Mapping):
        return {k: _tree_from_arrays(v, dtype, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_from_arrays(v, dtype, dev) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(
        device=dev, dtype=dtype)


def pna_params_from_arrays(params: Mapping[str, Any],
                           dtype: torch.dtype = torch.float32,
                           device: DeviceLike = None) -> Dict[str, Any]:
    """PNA parameters in the reference's names and layouts (``proj``, a
    list of ``layers`` with ``msg`` / ``post_id`` / ``post_amp`` /
    ``post_att``, ``head``) of arrays, as the port's tensors in ``dtype``
    on ``device``."""
    return _tree_from_arrays(params, dtype, resolve_device(device))


def transformer_params_from_arrays(params: Mapping[str, Any],
                                   dtype: torch.dtype = torch.float32,
                                   device: DeviceLike = None
                                   ) -> Dict[str, Any]:
    """Transformer parameters in the reference's names and layouts
    (``embed``, ``layers`` stacked along a leading L axis, ``final_ln``,
    ``lm_head`` when untied) of arrays, as the port's tensors in ``dtype``
    on ``device``."""
    return _tree_from_arrays(params, dtype, resolve_device(device))


def dimenet_params_from_arrays(params: Mapping[str, Any],
                               dtype: torch.dtype = torch.float32,
                               device: DeviceLike = None) -> Dict[str, Any]:
    """DimeNet parameters (``embed``, a list of ``blocks``, ``rbf_emb``,
    ``msg_init``, ``head``) of arrays, as tensors on ``device``."""
    return _tree_from_arrays(params, dtype, resolve_device(device))


def nequip_params_from_arrays(params: Mapping[str, Any],
                              dtype: torch.dtype = torch.float32,
                              device: DeviceLike = None) -> Dict[str, Any]:
    """NequIP parameters (``embed``, a list of ``layers`` with ``radial`` /
    ``self`` / ``mix``, ``head``) of arrays, as tensors on ``device``."""
    return _tree_from_arrays(params, dtype, resolve_device(device))


def mace_params_from_arrays(params: Mapping[str, Any],
                            dtype: torch.dtype = torch.float32,
                            device: DeviceLike = None) -> Dict[str, Any]:
    """MACE parameters (``embed``, a list of ``layers`` with ``radial`` /
    a list of ``combine`` / ``self``, ``head``) of arrays, as tensors on
    ``device``."""
    return _tree_from_arrays(params, dtype, resolve_device(device))


def mind_params_from_arrays(params: Mapping[str, Any],
                            dtype: torch.dtype = torch.float32,
                            device: DeviceLike = None) -> Dict[str, Any]:
    """MIND parameters (``items`` table, ``s_map``, ``out_mlp``) of arrays,
    as tensors on ``device``."""
    return _tree_from_arrays(params, dtype, resolve_device(device))


def _exact_from_arrays(tree, dev: torch.device):
    """Arrays as tensors of their own dtype (int8 codes stay int8)."""
    if isinstance(tree, Mapping):
        return {k: _exact_from_arrays(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_exact_from_arrays(v, dev) for v in tree]
    return torch.from_numpy(np.array(tree)).to(dev)


def train_state_from_arrays(state, dtype: torch.dtype = torch.float32,
                            device: DeviceLike = None) -> TrainState:
    """A train state of arrays with the reference's fields -- ``params``,
    ``opt_state`` (``step``, ``m``, ``v``: fp32 moments, or 8-bit ones as
    ``{"q": int8, "s": float32}`` per leaf) and ``ef`` (or None) -- as the
    port's :class:`~repro_torch.train.trainer.TrainState` on ``device``:
    parameters in ``dtype``, everything else in its own dtype."""
    dev = resolve_device(device)
    o = state.opt_state
    return TrainState(
        params=_tree_from_arrays(state.params, dtype, dev),
        opt_state=AdamState(step=_exact_from_arrays(o.step, dev),
                            m=_exact_from_arrays(o.m, dev),
                            v=_exact_from_arrays(o.v, dev)),
        ef=None if state.ef is None else _exact_from_arrays(state.ef, dev))

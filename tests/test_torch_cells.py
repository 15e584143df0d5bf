"""The port's 40 cells (``launch/steps.py``) against the reference's
``build_cell``, in one process, on 16 x 16 and 2 x 16 x 16.

The reference side builds on ``AbstractMesh``es with Auto axes (as
tests/test_torch_sharding.py does), so nothing is lowered; the port side
builds on its shape-only production meshes (meta tensors, nothing drawn).
For every cell: the kind, every argument's path, shape and dtype, every
input and output leaf's spec, ``model_flops_per_step`` exactly, the note,
and every config choice the reference's cell makes (read from the config
its step closes over).  ``calibration_cells`` is held the same way at
L = 2 and L = 4, and the dataclass fields of every config class are held
to the reference's.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import inspect
import pkgutil

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

import repro
import repro_torch
from repro.configs import all_cells
from repro.launch import steps as r_steps
from repro_torch.launch import steps as p_steps
from repro_torch.launch.mesh import make_production_mesh

MESHES = {"16x16": ((16, 16), ("data", "model"), False),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"), True)}
CELLS = [(a, s) for a, s in all_cells()]
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.int8): torch.int8,
          jnp.dtype(jnp.bool_): torch.bool}


@functools.lru_cache(maxsize=None)
def ref_mesh(name):
    shape, axes, _ = MESHES[name]
    return AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def port_mesh(name):
    return make_production_mesh(multi_pod=MESHES[name][2])


def _find(obj, cls_name, seen=None):
    """The instance of class ``cls_name`` a step function closes over."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return None
    seen.add(id(obj))
    if type(obj).__name__ == cls_name:
        return obj
    kids = []
    if isinstance(obj, functools.partial):
        kids = list(obj.args) + list(obj.keywords.values()) + [obj.func]
    elif inspect.isfunction(obj):
        kids = [c.cell_contents for c in (obj.__closure__ or ())]
    for k in kids:
        hit = _find(k, cls_name, seen)
        if hit is not None:
            return hit
    return None


def _ref_leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _axes(entry):
    if entry is None:
        return None
    return entry if isinstance(entry, str) else tuple(entry)


def _choices(cfg, mesh_name):
    """The config choices a cell makes, in a form both packages share."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in ("mesh", "cp_mesh"):
            out[f.name] = None if v is None else tuple(v.shape.items())
        elif f.name == "moe":
            out["moe"] = None if v is None else _choices(v, mesh_name)
        elif f.name == "dtype":
            out[f.name] = str(v).split(".")[-1].replace("'>", "")
        elif f.name in ("act_pspec", "dispatch_pspec", "logits_pspec"):
            out[f.name] = None if v is None else tuple(_axes(e) for e in v)
        elif isinstance(v, (tuple, list)):
            out[f.name] = tuple(v)
        else:
            out[f.name] = v
    return out


CFG_CLASSES = {"lm": "TransformerConfig", "pna": "PNAConfig",
               "dimenet": "DimeNetConfig", "nequip": "NequIPConfig",
               "mace": "MACEConfig", "mind": "MINDConfig"}


def _cfg_class(arch):
    from repro_torch.configs import get_arch
    spec = get_arch(arch)
    return CFG_CLASSES["lm" if spec.family == "lm" else arch]


def _hold(rc, pc, mesh_name):
    assert pc.arch_id == rc.arch_id and pc.shape_name == rc.shape_name
    assert pc.kind == rc.kind
    assert pc.note == rc.note
    assert pc.model_flops_per_step == rc.model_flops_per_step
    ra = _ref_leaves(rc.args)
    pa = dict(p_steps.tree_paths(pc.args))
    assert sorted(pa) == sorted(ra)   # jax sorts dict keys
    for path, sds in ra.items():
        assert tuple(pa[path].shape) == tuple(sds.shape), path
        assert pa[path].dtype == DTYPES[jnp.dtype(sds.dtype)], path
        assert pa[path].device.type == "meta", path
    for rtree, ptree in ((rc.in_shardings, pc.in_specs),
                         (rc.out_shardings, pc.out_specs)):
        rs = {k: tuple(v.spec) for k, v in _ref_leaves(rtree).items()}
        ps = dict(p_steps.tree_paths(ptree))
        assert ps == rs
    cls = _cfg_class(rc.arch_id)
    ref_cfg = _find(rc.fn, cls)
    assert ref_cfg is not None, cls
    assert type(pc.cfg).__name__ == cls
    assert _choices(pc.cfg, mesh_name) == _choices(ref_cfg, mesh_name)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_matches_reference(arch, shape, mesh_name):
    rc = r_steps.build_cell(arch, shape, ref_mesh(mesh_name))
    pc = p_steps.build_cell(arch, shape, port_mesh(mesh_name))
    _hold(rc, pc, mesh_name)


LM_CELLS = [(a, s) for a, s in CELLS if a in (
    "yi-34b", "starcoder2-3b", "gemma-2b", "qwen2-moe-a2.7b",
    "qwen3-moe-235b-a22b")]


@pytest.mark.parametrize("arch,shape", LM_CELLS)
def test_calibration_cells_match_reference(arch, shape):
    rcs = r_steps.calibration_cells(arch, shape, ref_mesh("16x16"))
    pcs = p_steps.calibration_cells(arch, shape, port_mesh("16x16"))
    assert [c.cfg.n_layers for c in pcs] == [2, 4]
    assert all(c.cfg.unroll_scans for c in pcs)
    for rc, pc in zip(rcs, pcs):
        _hold(rc, pc, "16x16")
    assert p_steps.calibration_cells("pna", "molecule",
                                     port_mesh("16x16")) is None


def _config_fields(pkg):
    out = {}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if m.name.endswith(".dryrun"):
            continue    # the reference's sets XLA_FLAGS when imported
        mod = importlib.import_module(m.name)
        for n, c in vars(mod).items():
            if (inspect.isclass(c) and dataclasses.is_dataclass(c)
                    and c.__module__ == mod.__name__
                    and n.endswith(("Config", "Spec", "Shape"))):
                out[(m.name.split(".", 1)[1], n)] = [
                    f.name for f in dataclasses.fields(c)]
    return out


# the port's kernel route flag takes the place of the reference's Pallas
# switches (Pallas interpret mode has no counterpart in the port)
KNOWN = {("core.executor", "ExecConfig"): ({"use_pallas", "interpret"},
                                           {"use_kernel"}),
         ("models.gnn.sage", "SAGEConfig"): ({"interpret"}, set())}


def test_config_dataclass_fields_match_reference():
    ref, port = _config_fields(repro), _config_fields(repro_torch)
    assert set(ref) == set(port)
    assert ("models.transformer", "TransformerConfig") in ref
    for key, fields in ref.items():
        got = port[key]
        drop, add = KNOWN.get(key, (set(), set()))
        assert [f for f in got if f not in add] == \
            [f for f in fields if f not in drop], key

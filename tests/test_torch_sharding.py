"""The port's sharding rules against the reference's, leaf by leaf, in one
process (no ranks).

For every one of the ten architectures' ``full()`` parameters, the port's
``launch/sharding.py`` must give each leaf the spec the reference's gives
it, on the production meshes (16 x 16, 2 x 16 x 16 with ``pod``) and on
2 x 4 and 1 x 1.  The reference's shapes come from ``jax.eval_shape`` and
its meshes are ``AbstractMesh``es; the port's tree holds meta tensors of
the same shapes at the same paths, so nothing is allocated (the port's
``init_params`` draws every weight, 235 B of them for qwen3-moe).  The fp32 and 8-bit
AdamW states (``['q']``/``['s']`` leaves), ``kv_cache_shardings``,
``batch_sharding`` and ``dim_sharding`` are held the same way, and the
rank mesh's error paths are checked without starting a process group.
"""
import functools
import importlib

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.configs import get_arch as r_get_arch
from repro.launch import sharding as r_sh
from repro.train import optimizer as r_opt
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import sharding as p_sh
from repro_torch.launch.mesh import (
    Mesh, data_axes, make_production_mesh, make_rank_mesh,
    require_rank_mesh,
)
from repro_torch.train import optimizer as p_opt

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "pod": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
MODULES = {"transformer": "models.transformer", "pna": "models.gnn.pna",
           "dimenet": "models.gnn.dimenet", "nequip": "models.gnn.nequip",
           "mace": "models.gnn.mace", "mind": "models.recsys.mind"}


def meshes(name):
    shape, axes = MESHES[name]
    return (AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes)),
            Mesh(shape, axes))


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    spec = r_get_arch(arch)
    mod = importlib.import_module(f"repro.{MODULES[spec.model]}")
    return jax.eval_shape(lambda: mod.init_params(jax.random.PRNGKey(0),
                                                  spec.full()))


def port_params(arch):
    """The reference's parameter tree as meta tensors (dicts and lists, as
    the port's own trees are laid out)."""
    return jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), ref_params(arch))


def ref_specs(tree, mesh):
    shardings = r_sh.params_shardings(tree, mesh)
    return {jax.tree_util.keystr(k): tuple(s.spec) for k, s in
            jax.tree_util.tree_flatten_with_path(shardings)[0]}


def port_specs(tree, mesh):
    specs = p_sh.spec_leaves(p_sh.params_shardings(tree, mesh))
    return dict(zip((p for p, _ in p_sh._with_paths(tree)), specs))


def shapes(tree):
    return {jax.tree_util.keystr(k): tuple(x.shape) for k, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_shapes(tree):
    return {p: tuple(x.shape) for p, x in p_sh._with_paths(tree)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_the_reference(arch, mesh_name):
    rmesh, pmesh = meshes(mesh_name)
    rp, pp = ref_params(arch), port_params(arch)
    assert port_shapes(pp) == shapes(rp)
    want = ref_specs(rp, rmesh)
    got = port_specs(pp, pmesh)
    assert got == want


@pytest.mark.parametrize("bits", [32, 8])
@pytest.mark.parametrize("mesh_name", ["16x16", "pod"])
def test_adamw_state_specs_match_the_reference(bits, mesh_name):
    """Moments inherit their parameter's spec; 8-bit codes and scales move
    the last dim's axis to the block-count dim when it divides."""
    rmesh, pmesh = meshes(mesh_name)
    for arch in ("starcoder2-3b", "qwen3-moe-235b-a22b", "mind"):
        rcfg = r_opt.AdamWConfig(state_bits=bits)
        rp = ref_params(arch)
        rs = jax.eval_shape(lambda: r_opt.init_state(
            jax.tree_util.tree_map(lambda s: jax.numpy.zeros(s.shape,
                                                             s.dtype), rp),
            rcfg))
        ps = p_opt.init_state(port_params(arch),
                              p_opt.AdamWConfig(state_bits=bits))
        assert port_shapes(ps) == shapes(rs), arch
        assert port_specs(ps, pmesh) == ref_specs(rs, rmesh), arch


@pytest.mark.parametrize("batch", [32, 3])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_kv_cache_and_batch_specs_match_the_reference(mesh_name, batch):
    """A batch that divides the data axes shards over them; one that does
    not puts the cache's sequence over every axis (split-KV decode)."""
    rmesh, pmesh = meshes(mesh_name)
    rcfg, pcfg = r_get_arch("yi-34b").full(), get_arch("yi-34b").full()
    want = {k: tuple(v.spec) for k, v in
            r_sh.kv_cache_shardings(rmesh, rcfg, batch, 4096).items()}
    assert p_sh.kv_cache_shardings(pmesh, pcfg, batch, 4096) == want
    for ndim, dim in ((2, 0), (3, 1)):
        assert p_sh.batch_sharding(pmesh, ndim, dim) == tuple(
            r_sh.batch_sharding(rmesh, ndim, dim).spec)
    assign = {0: data_axes(pmesh), 2: "model"}
    assert p_sh.dim_sharding(pmesh, 3, assign) == tuple(
        r_sh.dim_sharding(rmesh, 3, assign).spec)
    assert p_sh.replicated(pmesh) == tuple(r_sh.replicated(rmesh).spec)


def test_production_mesh_and_data_axes():
    from repro.launch import mesh as r_mesh
    one, pod = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert data_axes(one) == ("data",) and data_axes(pod) == ("pod", "data")
    for name in MESHES:
        rmesh, pmesh = meshes(name)
        assert data_axes(pmesh) == r_mesh.data_axes(rmesh)
        assert pmesh.shape == dict(rmesh.shape)
    assert not one.has_ranks
    with pytest.raises(TypeError, match="rank mesh"):
        require_rank_mesh(one, "a sharded layer")


def test_rank_mesh_refuses_what_it_cannot_run():
    """Checked before any process group exists: nccl with ranks that share
    a card, a world size that is not the mesh's, an unknown backend."""
    with pytest.raises(ValueError, match="backend='gloo'"):
        make_rank_mesh(2, 0, "tcp://localhost:1", (2,), ("data",),
                       backend="nccl", devices="cuda:0")
    with pytest.raises(ValueError, match="share cuda:1"):
        make_rank_mesh(3, 0, "tcp://localhost:1", (3,), ("data",),
                       backend="nccl", devices=["cuda:0", "cuda:1",
                                                "cuda:1"])
    with pytest.raises(ValueError, match="CUDA devices only"):
        make_rank_mesh(2, 0, "tcp://localhost:1", (2,), ("data",),
                       backend="nccl", devices="cpu")
    with pytest.raises(ValueError, match="holds 8 ranks"):
        make_rank_mesh(4, 0, "tcp://localhost:1", (2, 4),
                       backend="gloo", devices="cpu")
    with pytest.raises(ValueError, match="name 'nccl' or 'gloo'"):
        make_rank_mesh(1, 0, "tcp://localhost:1", (1,), ("data",),
                       backend="mpi", devices="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        Mesh((2, 4), ("data",))


def test_local_blocks_tile_the_tensor():
    """Every rank's block, cut by ``local_block``, tiles the full tensor
    once, for a spec over one axis, a tuple of axes and none."""
    mesh = Mesh((2, 4), ("data", "model"))
    full = torch.arange(8 * 12 * 3).reshape(8, 12, 3)
    for sp in (("data", "model", None), (("data", "model"), None, None),
               (None, "model", None), ()):
        seen = torch.zeros_like(full)
        for r in range(mesh.size):
            mesh.rank = r
            blk = p_sh.local_block(full, sp, mesh)
            seen += torch.isin(full, blk).long()
        n = p_sh.n_replicas(sp, mesh)
        assert int(seen.min()) == int(seen.max()) == n, sp

"""The port's molecular GNNs == the reference's, on the CPU.

Radial bases, irreps (Clebsch-Gordan tables, spherical harmonics, the
tensor product), DimeNet, NequIP and MACE at their ``smoke()`` configs on
batches of small random molecules drawn with numpy from a seed and padded
by each package's ``pad_graph`` (padded edges have r = 0).  Weights are the
reference's, carried by ``interop``; the reference runs under ``jax.jit``
(config static).  Tolerances: CG tables and float64 spherical harmonics
1e-12; fp32 forward passes and losses rtol 1e-5 with an atol of 1e-6 of
the tensor's largest magnitude; gradients and forces rtol 1e-4 with an
atol of 1e-5 of the largest magnitude; equivariance (the port alone):
energies rtol 1e-5, rotated forces atol 1e-5 of their largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as r_configs
from repro.models.gnn import dimenet as r_dimenet
from repro.models.gnn import graphdata as r_gd
from repro.models.gnn import irreps as r_irreps
from repro.models.gnn import mace as r_mace
from repro.models.gnn import nequip as r_nequip
from repro.models.gnn import radial as r_radial
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.models.gnn import dimenet as p_dimenet
from repro_torch.models.gnn import graphdata as p_gd
from repro_torch.models.gnn import irreps as p_irreps
from repro_torch.models.gnn import mace as p_mace
from repro_torch.models.gnn import nequip as p_nequip
from repro_torch.models.gnn import radial as p_radial
from repro_torch.train.checkpoint import _flatten_with_paths
from repro_torch.train.trainer import value_and_grad

FWD = (1e-5, 1e-6)
GRAD = (1e-4, 1e-5)
G = 4
MODELS = {"dimenet": (r_dimenet, p_dimenet,
                      interop.dimenet_params_from_arrays),
          "nequip": (r_nequip, p_nequip, interop.nequip_params_from_arrays),
          "mace": (r_mace, p_mace, interop.mace_params_from_arrays)}


def close(got, want, tol, what=""):
    rtol, atol = tol
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want)
    atol = atol * max(float(np.abs(w).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def trees_close(got, want, tol, what=""):
    g, w = _flatten_with_paths(got), _flatten_with_paths(want)
    assert set(g) == set(w), what
    for k in g:
        close(g[k], w[k], tol, f"{what} {k}")


def molecules(n_types, seed=0, n=6, e=14, node_pad=32, edge_pad=64):
    """G random molecules of n atoms and e directed bonds (no self-loops),
    positions spread over a few angstroms, padded by both packages."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for g in range(G):
        s = rng.integers(0, n, e)
        src.append(s + g * n)
        dst.append((s + rng.integers(1, n, e)) % n + g * n)
    src, dst = np.concatenate(src), np.concatenate(dst)
    pos = (rng.standard_normal((G * n, 3)) * 1.5).astype(np.float32)
    feat = rng.integers(0, n_types, G * n).astype(np.int32)
    gid = np.repeat(np.arange(G), n).astype(np.int32)
    kw = dict(positions=pos, graph_id=gid, node_pad=node_pad,
              edge_pad=edge_pad)
    rgb = r_gd.pad_graph(feat, src, dst, **kw)
    pgb = p_gd.pad_graph(feat, src, dst, device="cpu", **kw)
    assert pgb.n_edges > len(src)                # padded edges, r = 0
    return rgb, pgb, (src, dst)


def triplets(src, dst):
    t = p_gd.build_triplets(src, dst)
    for a, b in zip(t, r_gd.build_triplets(src, dst)):
        np.testing.assert_array_equal(a, b)
    return (tuple(jnp.asarray(a) for a in t),
            tuple(torch.from_numpy(a) for a in t))


def setup(arch, seed=1):
    rmod, pmod, conv = MODELS[arch]
    rcfg = dataclasses.replace(r_configs.get_arch(arch).smoke(), n_graphs=G)
    cfg = dataclasses.replace(get_arch(arch).smoke(), n_graphs=G)
    rp = rmod.init_params(jax.random.PRNGKey(seed), rcfg)
    pp = conv(jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return rmod, pmod, rcfg, cfg, rp, pp


def port_cfg_of(rcfg, pcls):
    kw = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(pcls)
          if f.name != "dtype"}
    return pcls(**kw)


# ------------------------------------------------------------------ radial

def test_radial_bases_and_padded_edge_gradients():
    rng = np.random.default_rng(0)
    vec = (rng.standard_normal((40, 3)) * 2).astype(np.float32)
    vec[:3] = 0.0                                   # padded edges: r = 0
    vj, vt = jnp.asarray(vec), torch.from_numpy(vec)
    close(p_radial.safe_norm(vt), r_radial.safe_norm(vj), FWD, "safe_norm")
    r = np.abs(rng.standard_normal(40) * 3).astype(np.float32)
    r[:2] = 0.0
    rj, rt = jnp.asarray(r), torch.from_numpy(r)
    close(p_radial.bessel_rbf(rt, 6, 5.0), r_radial.bessel_rbf(rj, 6, 5.0),
          FWD, "bessel")
    close(p_radial.poly_envelope(rt, 5.0), r_radial.poly_envelope(rj, 5.0),
          FWD, "envelope")
    c = np.clip(rng.standard_normal(40), -1, 1).astype(np.float32)
    close(p_radial.legendre(torch.from_numpy(c), 7),
          r_radial.legendre(jnp.asarray(c), 7), FWD, "legendre")
    close(p_radial.spherical_basis(rt, torch.from_numpy(c), 4, 3, 5.0),
          r_radial.spherical_basis(rj, jnp.asarray(c), 4, 3, 5.0), FWD,
          "spherical_basis")
    x = vt.clone().requires_grad_()
    (g,) = torch.autograd.grad(p_radial.safe_norm(x).sum(), x)
    want = jax.grad(lambda v: r_radial.safe_norm(v).sum())(vj)
    assert torch.isfinite(g).all() and (g[:3] == 0).all()
    close(g, want, GRAD, "safe_norm gradient")


# ------------------------------------------------------------------ irreps

@pytest.mark.parametrize("l3", [0, 1, 2, 3])
def test_clebsch_gordan_tables(l3):
    for l1 in range(3):
        for l2 in range(3):
            got, ok = p_irreps.cg_real(l1, l2, l3)
            want, rok = r_irreps.cg_real(l1, l2, l3)
            assert ok == rok
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert p_irreps.valid_paths((0, 1, 2), (0, 1, 2), (0, 1, 2)) == \
        r_irreps.valid_paths((0, 1, 2), (0, 1, 2), (0, 1, 2))
    t = p_irreps.cg_tensor(1, 1, min(l3, 2), torch.float32,
                           torch.device("cpu"))
    assert t is p_irreps.cg_tensor(1, 1, min(l3, 2), torch.float32,
                                   torch.device("cpu"))     # built once


def test_spherical_harmonics_float64():
    rng = np.random.default_rng(1)
    vec = rng.standard_normal((30, 3))
    vec[:2] = 0.0
    with jax.enable_x64(True):
        want = r_irreps.spherical_harmonics(jnp.asarray(vec), 2)
        want = {l: np.asarray(x) for l, x in want.items()}
    got = p_irreps.spherical_harmonics(torch.from_numpy(vec), 2)
    assert set(got) == set(want) == {0, 1, 2}
    for l in got:
        assert got[l].dtype == torch.float64
        np.testing.assert_allclose(got[l].numpy(), want[l], rtol=0,
                                   atol=1e-12, err_msg=f"l={l}")
    assert (got[1][:2] == 0).all() and (got[2][:2] == 0).all()


def test_tensor_product_linear_gate_norms():
    rng = np.random.default_rng(2)
    E, M = 11, 5

    def arr(*s):
        return rng.standard_normal(s).astype(np.float32)

    feat = {l: arr(E, M, 2 * l + 1) for l in (0, 1, 2)}
    sh = {l: arr(E, 1, 2 * l + 1) for l in (0, 1, 2)}
    paths = r_irreps.valid_paths((0, 1, 2), (0, 1, 2), (0, 1, 2))
    w = {p: arr(E, M) for p in paths}
    lin = {f"l{l}": arr(M, M) for l in (0, 1, 2)}

    def J(d):
        return {k: jnp.asarray(v) for k, v in d.items()}

    def T(d):
        return {k: torch.from_numpy(v) for k, v in d.items()}

    want = r_irreps.tensor_product(J(feat), J(sh), J(w), (0, 1, 2))
    got = p_irreps.tensor_product(T(feat), T(sh), T(w), (0, 1, 2))
    for l in want:
        close(got[l], want[l], FWD, f"tensor_product l={l}")
    for name in ("irrep_linear",):
        want = getattr(r_irreps, name)(J(lin), J(feat))
        got = getattr(p_irreps, name)(T(lin), T(feat))
        for l in want:
            close(got[l], want[l], FWD, f"{name} l={l}")
    for l, x in p_irreps.gate(T(feat)).items():
        close(x, r_irreps.gate(J(feat))[l], FWD, f"gate l={l}")
    close(p_irreps.norm_squared(T(feat)), r_irreps.norm_squared(J(feat)),
          FWD, "norm_squared")


# ------------------------------------------------------------------ models

def _jit_train(rmod, rcfg, trip=None):
    if trip is None:
        fwd = jax.jit(lambda p, gb: rmod.forward(p, gb, rcfg))
        vg = jax.jit(jax.value_and_grad(
            lambda p, gb, t: rmod.energy_loss(p, gb, rcfg, t)))
    else:
        fwd = jax.jit(lambda p, gb: rmod.forward(p, gb, rcfg, trip))
        vg = jax.jit(jax.value_and_grad(
            lambda p, gb, t: rmod.energy_loss(p, gb, rcfg, trip, t)))
    return fwd, vg


@pytest.mark.parametrize("arch", ["dimenet", "nequip", "mace"])
def test_forward_loss_and_gradients(arch):
    rmod, pmod, rcfg, cfg, rp, pp = setup(arch)
    rgb, pgb, (src, dst) = molecules(cfg.n_types)
    targets = np.random.default_rng(3).standard_normal(G).astype(np.float32)
    if arch == "dimenet":
        rtri, ptri = triplets(src, dst)
        fwd, vg = _jit_train(rmod, rcfg, rtri)
        loss_fn = lambda p, t: pmod.energy_loss(p, pgb, cfg, ptri, t)
        got = pmod.forward(pp, pgb, cfg, ptri)
    else:
        fwd, vg = _jit_train(rmod, rcfg)
        loss_fn = lambda p, t: pmod.energy_loss(p, pgb, cfg, t)
        got = pmod.forward(pp, pgb, cfg)
    want = fwd(rp, rgb)
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want, FWD, f"{arch} forward")
    want_loss, want_g = vg(rp, rgb, jnp.asarray(targets))
    loss, grads = value_and_grad(loss_fn, pp, torch.from_numpy(targets))
    close(loss, want_loss, FWD, f"{arch} loss")
    trees_close(grads, want_g, GRAD, f"{arch} gradient")
    assert all(torch.isfinite(g).all() for g in
               _flatten_with_paths(grads).values())


def test_nequip_forces():
    rmod, pmod, rcfg, cfg, rp, pp = setup("nequip")
    rgb, pgb, _ = molecules(cfg.n_types, seed=4)
    want = jax.jit(lambda p, gb: rmod.forces(p, gb, rcfg))(rp, rgb)
    got = pmod.forces(pp, pgb, cfg)
    assert torch.isfinite(got).all()
    close(got, want, GRAD, "nequip forces")
    assert (got[pgb.node_mask.logical_not()] == 0).all()


def rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    return (q if np.linalg.det(q) > 0 else -q).astype(np.float32)


def energy_and_forces(pmod, params, gb, cfg):
    pos = gb.positions.detach().requires_grad_()
    e = pmod.forward(params, dataclasses.replace(gb, positions=pos), cfg)
    (g,) = torch.autograd.grad(e.sum(), pos)
    return e.detach(), -g


@pytest.mark.parametrize("arch", ["nequip", "mace"])
def test_rotation_equivariance(arch):
    """Energies unchanged and forces rotated under a rotation of every
    position (the port alone)."""
    _, pmod, _, cfg, _, pp = setup(arch, seed=2)
    _, gb, _ = molecules(cfg.n_types, seed=5)
    R = torch.from_numpy(rotation(6))
    e, f = energy_and_forces(pmod, pp, gb, cfg)
    rot = dataclasses.replace(gb, positions=gb.positions @ R.T)
    e2, f2 = energy_and_forces(pmod, pp, rot, cfg)
    close(e2, e.numpy(), (1e-5, 1e-6), f"{arch} energy")
    close(f2, (f @ R.T).numpy(), (0, 1e-5), f"{arch} forces")
    if arch == "nequip":
        close(pmod.forces(pp, gb, cfg), f.numpy(), (0, 1e-6),
              "forces() == -dE/dpos")


def test_registry_configs_match_the_reference():
    for arch, pcls in (("dimenet", p_dimenet.DimeNetConfig),
                       ("nequip", p_nequip.NequIPConfig),
                       ("mace", p_mace.MACEConfig)):
        for which in ("full", "smoke"):
            ref = getattr(r_configs.get_arch(arch), which)()
            got = getattr(get_arch(arch), which)()
            assert got == port_cfg_of(ref, pcls), (arch, which)
            assert got.dtype == torch.float32
        rs, ps = r_configs.get_arch(arch), get_arch(arch)
        assert (ps.family, ps.model, ps.source) == (rs.family, rs.model,
                                                    rs.source)
        _, pmod, _, cfg, rp, _ = setup(arch)
        shapes = {k: tuple(v.shape) for k, v in
                  _flatten_with_paths(pmod.init_params(
                      torch.Generator().manual_seed(0), cfg,
                      device="cpu")).items()}
        assert shapes == {k: tuple(np.shape(v)) for k, v in
                          _flatten_with_paths(rp).items()}, arch

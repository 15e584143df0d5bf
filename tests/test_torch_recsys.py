"""The port's recommender (MIND) == the reference's, on the CPU, and the
registry of all ten architectures.

Ids, masks and targets are drawn with numpy from a seed; weights are the
reference's, carried by ``interop.mind_params_from_arrays``; the reference
runs under ``jax.jit`` (config static).  The routing logits' initial draw
is the reference's ``jax.random.normal(PRNGKey(7), (1, L, K))``, which the
port reproduces without JAX: its bits exactly, its values within 1e-6.
Tolerances, fp32: embedding gathers exact; forward passes and losses rtol
1e-5 with an atol of 1e-6 of the tensor's largest magnitude; gradients
rtol 1e-4 with an atol of 1e-5 of the largest gradient in the tree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as r_configs
from repro.models.recsys import embedding as r_emb
from repro.models.recsys import mind as r_mind
from repro_torch import configs as p_configs
from repro_torch import interop
from repro_torch.models.recsys import embedding as p_emb
from repro_torch.models.recsys import mind as p_mind
from repro_torch.train.checkpoint import _flatten_with_paths
from repro_torch.train.trainer import value_and_grad
from repro_torch.utils import jax_random

FWD = (1e-5, 1e-6)
GRAD = (1e-4, 1e-5)


def close(got, want, tol, what=""):
    rtol, atol = tol
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want)
    atol = atol * max(float(np.abs(w).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def setup(seed=0):
    rcfg = r_configs.get_arch("mind").smoke()
    cfg = p_configs.get_arch("mind").smoke()
    rp = r_mind.init_params(jax.random.PRNGKey(seed), rcfg)
    pp = interop.mind_params_from_arrays(
        jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return rcfg, cfg, rp, pp


def history(cfg, B, seed=1, ragged=True):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, cfg.n_items, (B, cfg.hist_len)).astype(np.int32)
    mask = np.ones((B, cfg.hist_len), bool)
    if ragged:
        lens = rng.integers(1, cfg.hist_len + 1, B)
        mask = np.arange(cfg.hist_len)[None, :] < lens[:, None]
    return hist, mask


# -------------------------------------------------------------- embedding

@pytest.mark.parametrize("combiner", ["mean", "sum"])
def test_embedding_bag(combiner):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (6, 7)).astype(np.int32)
    mask = rng.random((6, 7)) < 0.6
    mask[0] = False                                # an empty bag
    want = r_emb.embedding_bag({"table": jnp.asarray(table)},
                               jnp.asarray(ids), jnp.asarray(mask), combiner)
    got = p_emb.embedding_bag({"table": torch.from_numpy(table)},
                              torch.from_numpy(ids), torch.from_numpy(mask),
                              combiner)
    close(got, want, FWD, combiner)
    np.testing.assert_array_equal(
        p_emb.embedding_lookup({"table": torch.from_numpy(table)},
                               torch.from_numpy(ids)).numpy(),
        np.asarray(r_emb.embedding_lookup({"table": jnp.asarray(table)},
                                          jnp.asarray(ids))))


def test_embedding_ids_out_of_range_raise_on_the_cpu():
    """The reference's ``jnp.take`` gives NaN rows there; the port refuses
    such ids rather than fault on the card."""
    p = p_emb.embedding_table_init(torch.Generator().manual_seed(0), 10, 4,
                                   device="cpu")
    for bad in ([[0, 10]], [[-1, 2]]):
        with pytest.raises(IndexError):
            p_emb.embedding_lookup(p, torch.tensor(bad))
    assert p_emb.embedding_lookup(p, torch.tensor([[9, 0]])).shape == (1, 2, 4)


# ------------------------------------------------------- routing-logit draw

@pytest.mark.parametrize("shape", [(1, 10, 4), (1, 50, 4), (1, 7, 3),
                                   (2, 1000)])
def test_routing_logit_draw_matches_jax(shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(7), shape))
    got = jax_random.normal(7, shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        jax_random.random_bits(7, shape),
        np.asarray(jax.random.bits(jax.random.PRNGKey(7), shape)))


@pytest.mark.parametrize("seed", [0, 1, 123456, 2 ** 31 - 1])
def test_normal_draw_other_seeds(seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (3, 64)))
    np.testing.assert_allclose(jax_random.normal(seed, (3, 64)), want,
                               rtol=0, atol=1e-6)


def test_routing_logits_cached_and_read_only():
    a = p_mind.routing_logits(10, 4, torch.float32, torch.device("cpu"))
    assert a is p_mind.routing_logits(10, 4, torch.float32,
                                      torch.device("cpu"))
    assert jax_random.normal(7, (1, 10, 4)).flags.writeable is False
    with pytest.raises(ValueError):
        jax_random.normal(-1, (2,))


# ------------------------------------------------------------------- MIND

@pytest.mark.parametrize("ragged", [False, True])
def test_interests(ragged):
    rcfg, cfg, rp, pp = setup()
    hist, mask = history(cfg, 8, ragged=ragged)
    want = jax.jit(lambda p, h, m: r_mind.interests(p, h, m, rcfg))(
        rp, jnp.asarray(hist), jnp.asarray(mask))
    got = p_mind.interests(pp, torch.from_numpy(hist),
                           torch.from_numpy(mask), cfg)
    assert tuple(got.shape) == (8, cfg.n_interests, cfg.embed_dim)
    close(got, want, FWD, "interests")


def test_train_loss_and_gradients():
    rcfg, cfg, rp, pp = setup(2)
    hist, mask = history(cfg, 16, seed=3)
    target = np.random.default_rng(4).integers(0, cfg.n_items, 16).astype(
        np.int32)
    rb = {"hist": jnp.asarray(hist), "hist_mask": jnp.asarray(mask),
          "target": jnp.asarray(target)}
    pb = {"hist": torch.from_numpy(hist), "hist_mask": torch.from_numpy(mask),
          "target": torch.from_numpy(target)}
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: r_mind.train_loss(p, b, rcfg)))(rp, rb)
    loss, grads = value_and_grad(
        lambda p, b: p_mind.train_loss(p, b, cfg), pp, pb)
    close(loss, want_loss, FWD, "train_loss")
    g, w = _flatten_with_paths(grads), _flatten_with_paths(want_g)
    assert set(g) == set(w)
    # atol of the tree's largest gradient: a bias's gradient sums the
    # batch's softmax residuals, which cancel to far below their terms
    scale = max(float(np.abs(np.asarray(x)).max()) for x in w.values())
    for k in g:
        np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                   rtol=GRAD[0], atol=GRAD[1] * scale,
                                   err_msg=f"gradient {k}")


def test_score_candidates_and_retrieval():
    rcfg, cfg, rp, pp = setup(5)
    hist, mask = history(cfg, 6, seed=6)
    cand = np.random.default_rng(7).integers(0, cfg.n_items, (6, 13)).astype(
        np.int32)
    want = jax.jit(lambda p, h, m, c: r_mind.score_candidates(
        p, h, m, c, rcfg))(rp, jnp.asarray(hist), jnp.asarray(mask),
                           jnp.asarray(cand))
    got = p_mind.score_candidates(pp, torch.from_numpy(hist),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(cand), cfg)
    close(got, want, FWD, "score_candidates")
    ids = np.arange(cfg.n_items, dtype=np.int32)
    want = jax.jit(lambda p, h, m, c: r_mind.retrieval_scores(
        p, h, m, rcfg, c))(rp, jnp.asarray(hist[:1]), jnp.asarray(mask[:1]),
                           jnp.asarray(ids))
    got = p_mind.retrieval_scores(pp, torch.from_numpy(hist[:1]),
                                  torch.from_numpy(mask[:1]), cfg,
                                  torch.from_numpy(ids))
    assert tuple(got.shape) == (cfg.n_items,)
    close(got, want, FWD, "retrieval_scores")


def test_logits_pspec_needs_the_multi_device_layer():
    _, cfg, _, pp = setup()
    hist, mask = history(cfg, 4)
    batch = {"hist": torch.from_numpy(hist),
             "hist_mask": torch.from_numpy(mask),
             "target": torch.zeros(4, dtype=torch.int32)}
    cfg = dataclasses.replace(cfg, logits_pspec=("data", None))
    with pytest.raises(TypeError, match="rank mesh"):
        p_mind.train_loss(pp, batch, cfg)
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((1,), ("data",), rank=0, device=torch.device("cpu"))
    for spec in ((None, "data"), ("data", "data")):
        with pytest.raises(ValueError, match="by rows only"):
            p_mind.train_loss(pp, batch, dataclasses.replace(
                cfg, logits_pspec=spec), mesh)


# ----------------------------------------------------------------- registry

def test_registry_holds_the_reference_archs():
    assert list(p_configs.ARCHS) == list(r_configs.ARCHS)
    assert list(p_configs.all_cells()) == list(r_configs.all_cells())
    assert len(list(p_configs.all_cells())) == 40
    for arch, rs in r_configs.ARCHS.items():
        ps = p_configs.get_arch(arch)
        assert (ps.arch_id, ps.family, ps.model, ps.source) == (
            rs.arch_id, rs.family, rs.model, rs.source)
        assert type(ps.full()).__name__ == type(rs.full()).__name__
    for which in ("full", "smoke"):
        ref = getattr(r_configs.get_arch("mind"), which)()
        kw = {f.name: getattr(ref, f.name)
              for f in dataclasses.fields(p_mind.MINDConfig)
              if f.name != "dtype"}
        assert getattr(p_configs.get_arch("mind"), which)() == \
            p_mind.MINDConfig(**kw)
    _, cfg, rp, _ = setup()
    shapes = {k: tuple(v.shape) for k, v in _flatten_with_paths(
        p_mind.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")).items()}
    assert shapes == {k: tuple(np.shape(v))
                      for k, v in _flatten_with_paths(rp).items()}

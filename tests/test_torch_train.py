"""The port's training runtime == the reference's, on the CPU.

Optimizer, trainer, gradient compression, checkpoints, the fault loop and
the training CLI.  Inputs are drawn with numpy from a seed; model weights
are the reference's, carried by ``interop``.  The optimizer is compared
with the reference run eagerly (op by op, as the port runs), models under
``jax.jit``.  Tolerances: fp32 AdamW params rtol 1e-6 (atol 1e-9) after 10
steps; 8-bit codes equal except ±1 where the scaled value sits within
float32 rounding of a .5 tie, and the dequantized moments within one
quantization step; trained models loss within 1e-4 and params rtol 1e-4
with an atol of 1e-5; gradient accumulation against the full batch at the
reference's own rtol 2e-4, atol 2e-5; the fault loop's final loss within
the reference's 5e-2 of an uninterrupted run.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as r_get_arch
from repro.data.tokens import token_batch
from repro.models import transformer as r_tfm
from repro.train import checkpoint as r_ckpt
from repro.train import optimizer as r_opt
from repro.train import trainer as r_trainer
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.models import transformer as p_tfm
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.train import checkpoint as p_ckpt
from repro_torch.train import compression as p_comp
from repro_torch.train import optimizer as p_opt
from repro_torch.train import trainer as p_trainer
from repro_torch.train.fault import FaultConfig, FaultTolerantLoop

ROOT = Path(__file__).resolve().parents[1]

R_CFG = r_tfm.TransformerConfig(name="tiny", n_layers=2, d_model=32,
                                n_heads=4, n_kv_heads=2, d_ff=64, vocab=61,
                                head_dim=8, remat=False)


def port_tfm_cfg(rcfg, dtype=torch.float32):
    kw = {f.name: getattr(rcfg, f.name)
          for f in dataclasses.fields(p_tfm.TransformerConfig)
          if f.name not in ("dtype", "moe")}
    return p_tfm.TransformerConfig(**kw, dtype=dtype)


P_CFG = port_tfm_cfg(R_CFG)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float32).numpy() \
            if x.is_floating_point() else x.detach().cpu().numpy()
    return np.asarray(x)


def host_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def r_leaves(tree):
    """The reference tree's leaves in the port's traversal order (dict
    insertion order; jax sorts keys)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in r_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in r_leaves(v)]
    return [] if tree is None else [tree]


def assert_trees_close(got, want, rtol, atol, what=""):
    g, w = tree_leaves(got), r_leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(to_np(a), np.asarray(b, np.float32)
                                   if np.asarray(b).dtype.kind == "f"
                                   else np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=f"{what} leaf {i}")


def lm_batch(step, batch=8, seq=16, vocab=R_CFG.vocab):
    x, y = token_batch(step, batch, seq, vocab)
    return (jnp.asarray(x), jnp.asarray(y)), (torch.from_numpy(x),
                                              torch.from_numpy(y))


def r_params(cfg=R_CFG, seed=0):
    return r_tfm.init_params(jax.random.PRNGKey(seed), cfg)


def p_params(rp, dtype=torch.float32):
    return interop.transformer_params_from_arrays(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), rp),
        dtype, "cpu")


def r_loss(cfg):
    return lambda p, b: r_tfm.lm_loss(p, b[0], b[1], cfg)


def p_loss(cfg):
    return lambda p, b: p_tfm.lm_loss(p, b[0], b[1], cfg)


# ---------------------------------------------------------------- optimizer

SHAPES = {"stack": (3, 40, 64), "row": (64,), "odd": (5, 7), "wide": (2, 300),
          "scalar": ()}


def opt_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.standard_normal(s) * scale, np.float32)
            for k, s in SHAPES.items()}


def both_tree(arrs):
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arrs.items()})


OCFG = dict(lr=1e-2, warmup_steps=3, total_steps=12, clip_norm=5.0)


def test_schedule():
    cfg = p_opt.AdamWConfig(**OCFG)
    rcfg = r_opt.AdamWConfig(**OCFG)
    for step in range(0, 16):
        got = p_opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = r_opt.schedule(rcfg, jnp.asarray(step, jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, err_msg=f"step {step}")


def test_global_norm_and_slices(monkeypatch):
    arrs = opt_tree(0, 3.0)
    rt, pt = both_tree(arrs)
    want = np.asarray(r_opt.global_norm(rt))
    np.testing.assert_allclose(p_opt.global_norm(pt).numpy(), want,
                               rtol=1e-6)
    monkeypatch.setattr(p_opt, "SLICE_ELEMS", 100)   # several rows a slice
    np.testing.assert_allclose(p_opt.global_norm(pt).numpy(), want,
                               rtol=1e-6)
    rows = [s[0].shape[0] for s in p_opt._slices(pt["stack"])]
    assert rows == [1, 1, 1]
    monkeypatch.setattr(p_opt, "SLICE_ELEMS", 14)
    assert [s[0].shape[0] for s in p_opt._slices(pt["odd"])] == [2, 2, 1]


@pytest.mark.parametrize("slice_elems", [1 << 24, 64])
def test_apply_updates_fp32_ten_steps(monkeypatch, slice_elems):
    """Ten AdamW steps from the same params and grads, the clip active:
    params rtol 1e-6 with an atol of 1e-8 (1e-6 of the lr: a param near
    zero differs by its update's last bits); moments rtol 1e-6 with an
    atol of 1e-6 of their largest magnitude (b1*m + (1-b1)*g cancels where
    g turns, and the clip scale carries the two packages' different sums
    of squares); slicing a leaf (64 elements: one row of ``stack``)
    changes no result."""
    monkeypatch.setattr(p_opt, "SLICE_ELEMS", slice_elems)
    cfg, rcfg = p_opt.AdamWConfig(**OCFG), r_opt.AdamWConfig(**OCFG)
    rp, pp = both_tree(opt_tree(1))
    rs, ps = r_opt.init_state(rp, rcfg), p_opt.init_state(pp, cfg)
    for step in range(10):
        rg, pg = both_tree(opt_tree(100 + step, 0.2 if step % 3 else 2.0))
        rp, rs, rinfo = r_opt.apply_updates(rp, rg, rs, rcfg)
        pp, ps, pinfo = p_opt.apply_updates(pp, pg, ps, cfg)
        for k in SHAPES:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]),
                                       rtol=1e-6, atol=1e-8,
                                       err_msg=f"{k} step {step}")
            for name, a, b in (("m", ps.m, rs.m), ("v", ps.v, rs.v)):
                want = np.asarray(b[k])
                np.testing.assert_allclose(
                    a[k].numpy(), want, rtol=1e-6,
                    atol=1e-6 * np.abs(want).max(),
                    err_msg=f"{name} {k} step {step}")
        np.testing.assert_allclose(pinfo["gnorm"].numpy(),
                                   np.asarray(rinfo["gnorm"]), rtol=1e-6)
        np.testing.assert_allclose(pinfo["lr"].numpy(),
                                   np.asarray(rinfo["lr"]), rtol=1e-6)
        assert int(ps.step) == int(rs.step) == step + 1


def _codes_agree(got_q, got_s, want_q, want_s, x, what):
    """Codes equal, or ±1 where ``x`` (the value before quantization, in
    float64) over the scale sits within float32 rounding of a .5 tie;
    scales within 1e-6."""
    gq, wq = got_q.numpy().astype(int), np.asarray(want_q).astype(int)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6,
                               atol=1e-30, err_msg=what)
    diff = np.abs(gq - wq)
    assert diff.max(initial=0) <= 1, what
    if diff.any():
        s = np.maximum(np.asarray(want_s, np.float64), 1e-12)
        frac = np.abs(np.abs(x / s) % 1.0 - 0.5)
        assert (frac[diff > 0] < 1e-4).all(), (what, frac[diff > 0])


def _pre_quant(b, g, state, info, cfg, k):
    """The reference's m and sqrt(v) of leaf ``k`` before requantization,
    in float64, blocked as its codes: from its state before the step, the
    gradient and the clip scale of its ``gnorm``."""
    shape = SHAPES[k]
    scale = min(1.0, cfg.clip_norm / max(float(info["gnorm"]), 1e-9))
    gs = np.asarray(g, np.float64) * scale
    deq = lambda d: np.asarray(d["q"], np.float64) * np.asarray(   # noqa
        d["s"], np.float64)
    m = cfg.beta1 * deq(state.m[k]).reshape(shape) + (1 - cfg.beta1) * gs
    v = cfg.beta2 * deq(state.v[k]).reshape(shape) ** 2 \
        + (1 - cfg.beta2) * gs * gs
    qshape = np.asarray(state.m[k]["q"]).shape
    return {"m": m.reshape(qshape), "v": np.sqrt(v).reshape(qshape)}


@pytest.mark.parametrize("slice_elems", [1 << 24, 64])
def test_apply_updates_8bit_ten_steps(monkeypatch, slice_elems):
    """Each of ten 8-bit steps from the reference's state before it: codes
    equal (±1 at a rounding tie), dequantized moments within one step of
    the block's scale, params within rtol 1e-6 (atol 1e-8); then the
    port's own ten-step trajectory: params within rtol 1e-4 of the
    reference's but where an off-by-one code at a tie moved one element's
    updates (at most 0.1% of them, each by less than the lr, 1e-2)."""
    monkeypatch.setattr(p_opt, "SLICE_ELEMS", slice_elems)
    kw = dict(OCFG, state_bits=8, block=32)
    cfg, rcfg = p_opt.AdamWConfig(**kw), r_opt.AdamWConfig(**kw)
    rp, pp = both_tree(opt_tree(2))
    rs = r_opt.init_state(rp, rcfg)
    own_p, own_s = pp, p_opt.init_state(pp, cfg)
    for step in range(10):
        rg, pg = both_tree(opt_tree(200 + step, 0.2 if step % 3 else 2.0))
        start = interop.train_state_from_arrays(
            r_trainer.TrainState(host_tree(rp), host_tree(rs)), device="cpu")
        pp, ps, _ = p_opt.apply_updates(start.params, pg, start.opt_state,
                                        cfg)
        own_p, own_s, _ = p_opt.apply_updates(own_p, pg, own_s, cfg)
        before = rs
        rp, rs, rinfo = r_opt.apply_updates(rp, rg, rs, rcfg)
        for k in SHAPES:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]),
                                       rtol=1e-6, atol=1e-8,
                                       err_msg=f"{k} step {step}")
            for name, a, b in (("m", ps.m, rs.m), ("v", ps.v, rs.v)):
                a, b = a[k], b[k]
                shape = SHAPES[k]
                got = p_opt._dequant8(a["q"], a["s"], shape).numpy()
                want = np.asarray(r_opt._dequant8(b["q"], b["s"], shape))
                step_size = np.broadcast_to(np.asarray(b["s"]),
                                            np.asarray(b["q"]).shape)
                assert (np.abs(got - want).reshape(-1)
                        <= step_size.reshape(-1) * (1 + 1e-6)).all(), \
                    f"{name} {k} step {step}"
                _codes_agree(a["q"], a["s"], b["q"], b["s"],
                             _pre_quant(b, rg[k], before, rinfo, rcfg,
                                        k)[name],
                             f"{name} {k} step {step}")
    for k in SHAPES:
        got, want = own_p[k].numpy(), np.asarray(rp[k])
        off = ~np.isclose(got, want, rtol=1e-4, atol=1e-6)
        assert off.mean() <= 1e-3 and np.abs(got - want).max() <= 1e-2, k


def test_quant8_codec():
    """Codes and scales of the codec on values with exact .5 ties (half to
    even, as ``jnp.round``), a true division by the scale, zeros and a
    last dim that no block size divides."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 2, 48)).astype(np.float32)
    x[0, 0, :2] = [127.0, 0.5]                    # scale 1: 0.5 -> 0
    x[0, 0, 2:32] = 2.5                           # 2.5 -> 2
    x[1] = 0.0
    for arr in (x, x[..., :45], x[0, 0, 0]):
        q, s = p_opt._quant8(torch.from_numpy(np.ascontiguousarray(arr)), 32)
        rq, rs = r_opt._quant8(jnp.asarray(arr), 32)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert int(p_opt._quant8(torch.from_numpy(x), 32)[0][0, 0, 0, 1]) == 0
    assert int(p_opt._quant8(torch.from_numpy(x), 32)[0][0, 0, 0, 2]) == 2


# ----------------------------------------------------------------- trainer

def test_starcoder2_smoke_trains_five_steps_like_the_reference():
    rcfg = r_get_arch("starcoder2-3b").smoke()
    cfg = get_arch("starcoder2-3b").smoke()
    rp = r_params(rcfg)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=50)
    rstep = jax.jit(r_trainer.make_train_step(r_loss(rcfg),
                                              r_opt.AdamWConfig(**kw)))
    pstep = p_trainer.make_train_step(p_loss(cfg), p_opt.AdamWConfig(**kw))
    rs = r_trainer.init_train_state(rp, r_opt.AdamWConfig(**kw))
    ps = p_trainer.init_train_state(p_params(rp), p_opt.AdamWConfig(**kw))
    for i in range(5):
        rb, pb = lm_batch(i, 4, 32, cfg.vocab)
        rs, rm = rstep(rs, rb)
        ps, pm = pstep(ps, pb)
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=0, atol=1e-4, err_msg=f"step {i}")
    assert_trees_close(ps.params, rs.params, 1e-4, 1e-5, "params")
    assert int(ps.opt_state.step) == 5


def test_grad_accum_matches_full_batch():
    pp = p_params(r_params())
    ocfg = p_opt.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=100)
    s1 = p_trainer.init_train_state(pp, ocfg)
    s2 = p_trainer.init_train_state(tree_map(torch.clone, pp), ocfg)
    full = p_trainer.make_train_step(p_loss(P_CFG), ocfg, grad_accum=1)
    acc = p_trainer.make_train_step(p_loss(P_CFG), ocfg, grad_accum=4)
    _, b = lm_batch(0)
    s1, m1 = full(s1, b)
    s2, m2 = acc(s2, b)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=2e-4)
    for a, c in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_grad_accum_like_the_reference():
    """grad_accum=2 over bf16 parameters: the fp32 sum of bf16 microbatch
    gradients, as the reference scans it, read in the first moment
    (0.1 times that mean) at the bf16 tolerance of the transformer tests:
    rtol 2e-2 with an atol of 2e-2 of the largest magnitude (the params
    after one Adam step are lr*sign(g), which a gradient near zero flips
    between two bf16 computations)."""
    rcfg = dataclasses.replace(R_CFG, dtype=jnp.bfloat16)
    cfg = port_tfm_cfg(rcfg, torch.bfloat16)
    rp = r_params(rcfg)
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=100)
    rstep = jax.jit(r_trainer.make_train_step(r_loss(rcfg),
                                              r_opt.AdamWConfig(**kw), 2))
    pstep = p_trainer.make_train_step(p_loss(cfg), p_opt.AdamWConfig(**kw), 2)
    rs, rm = rstep(r_trainer.init_train_state(rp, r_opt.AdamWConfig(**kw)),
                   lm_batch(0)[0])
    ps, pm = pstep(p_trainer.init_train_state(p_params(rp, torch.bfloat16),
                                              p_opt.AdamWConfig(**kw)),
                   lm_batch(0)[1])
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               atol=1e-2)
    for a, b in zip(tree_leaves(ps.opt_state.m), r_leaves(rs.opt_state.m)):
        assert a.dtype == torch.float32
        want = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())
    assert all(a.dtype == torch.bfloat16 for a in tree_leaves(ps.params))


# -------------------------------------------------------------- compression

def test_compressed_dp_one_shard_like_the_reference():
    from jax.sharding import Mesh
    rp = r_params()
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=100)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    rstep = jax.jit(r_trainer.make_compressed_dp_step(
        r_loss(R_CFG), r_opt.AdamWConfig(**kw), mesh))
    pstep = p_trainer.make_compressed_dp_step(p_loss(P_CFG),
                                              p_opt.AdamWConfig(**kw))
    rs = r_trainer.init_train_state(rp, r_opt.AdamWConfig(**kw),
                                    compressed_dp=True)
    ps = p_trainer.init_train_state(p_params(rp), p_opt.AdamWConfig(**kw),
                                    compressed_dp=True)
    for i in range(2):
        rb, pb = lm_batch(i)
        with mesh:
            rs, rm = rstep(rs, rb)
        ps, pm = pstep(ps, pb)
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   atol=1e-5, err_msg=f"step {i}")
    # a gradient's int8 code may round the other way at a .5 tie between
    # the compiled reference and the port: that element's reduced gradient
    # moves by one scale, its update by less than the lr, its error
    # feedback by one scale
    for name, got, want, bound in (("params", ps.params, rs.params, 1e-2),
                                   ("ef", ps.ef, rs.ef, None)):
        for i, (a, b) in enumerate(zip(tree_leaves(got), r_leaves(want))):
            a, b = a.numpy(), np.asarray(b)
            off = ~np.isclose(a, b, rtol=1e-4, atol=1e-5 if bound else 1e-6)
            assert off.mean() <= 1e-3, (name, i, off.sum())
            assert bound is None or np.abs(a - b).max() <= bound, (name, i)


def oracle_reduce(gs, es):
    """The compressed mean in numpy: x_i = g_i + e_i, one scale (max of
    the shards' absmax over 127, at least 1e-12), codes
    clip(round(x_i / scale), -127, 127) summed, times the scale over n."""
    xs = [g.astype(np.float32) + e for g, e in zip(gs, es)]
    scale = np.float32(max(np.float32(np.abs(x).max()) for x in xs)
                       / np.float32(127.0))
    scale = max(scale, np.float32(1e-12))
    qs = [np.clip(np.round(x / scale), -127, 127).astype(np.int32)
          for x in xs]
    tot = sum(qs[1:], qs[0])
    red = tot.astype(np.float32) * scale / np.float32(len(xs))
    return red, [x - q.astype(np.float32) * scale for x, q in zip(xs, qs)]


@pytest.mark.parametrize("n_shards", [2, 4])
def test_compressed_dp_shards_against_the_formula(n_shards):
    """Two steps of the N-shard step against a numpy oracle of the
    compressed mean on the shards' own gradients (the reference's
    multi-device path does not run on this JAX): reduced gradients and
    error feedback exact, params equal to an AdamW step on the oracle's
    mean."""
    pp = p_params(r_params())
    ocfg = p_opt.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=100)
    step = p_trainer.make_compressed_dp_step(p_loss(P_CFG), ocfg, n_shards)
    state = p_trainer.init_train_state(pp, ocfg, compressed_dp=True,
                                       n_shards=n_shards)
    assert tree_leaves(state.ef)[0].shape[0] == n_shards
    for i in range(2):
        _, b = lm_batch(i)
        parts = p_trainer._split(b, n_shards)
        shard_grads, losses = [], []
        for mb in parts:
            loss, g = p_trainer.value_and_grad(p_loss(P_CFG), state.params,
                                               mb)
            losses.append(float(loss))
            shard_grads.append([t.numpy() for t in tree_leaves(g)])
        efs = [t.numpy() for t in tree_leaves(state.ef)]
        want_red, want_ef = [], []
        for j in range(len(efs)):
            red, res = oracle_reduce([sg[j] for sg in shard_grads],
                                     [efs[j][s] for s in range(n_shards)])
            want_red.append(red)
            want_ef.append(np.stack(res))
        expect_p, _, _ = p_opt.apply_updates(
            tree_map(torch.clone, state.params),
            tree_unflatten(state.params, [
                torch.from_numpy(r) for r in want_red]),
            p_opt.AdamState(state.opt_state.step.clone(),
                            tree_map(torch.clone, state.opt_state.m),
                            tree_map(torch.clone, state.opt_state.v)), ocfg)
        state, m = step(state, b)
        np.testing.assert_allclose(float(m["loss"]), np.mean(losses),
                                   rtol=1e-6)
        for got, want in zip(tree_leaves(state.ef), want_ef):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
        for got, want in zip(tree_leaves(state.params),
                             tree_leaves(expect_p)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-9)


def test_compressed_psum_against_the_reference_one_shard():
    """One shard: the codes, the scale and the residual of
    ``compressed_psum`` against the reference's under a 1-device
    ``shard_map``."""
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.train import compression as r_comp
    from repro.utils.compat import shard_map
    x = (np.random.default_rng(4).standard_normal((6, 50)) * 3
         ).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    red, res = shard_map(lambda a: r_comp.compressed_psum(a, "data"),
                         mesh=mesh, in_specs=P(), out_specs=(P(), P()),
                         check_vma=False)(jnp.asarray(x))
    pred, pres = p_comp.compressed_psum([torch.from_numpy(x)])
    np.testing.assert_array_equal(pred.numpy(), np.asarray(red))
    np.testing.assert_array_equal(pres[0].numpy(), np.asarray(res))


# -------------------------------------------------------------- checkpoints

def tiny_state(bits, seed=0):
    """A reference train state after one step, and the port's copy."""
    ocfg = r_opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=100,
                             state_bits=bits)
    step = jax.jit(r_trainer.make_train_step(r_loss(R_CFG), ocfg))
    rs, _ = step(r_trainer.init_train_state(r_params(seed=seed), ocfg),
                 lm_batch(0)[0])
    return rs, interop.train_state_from_arrays(host_tree(rs), device="cpu")


def flat_ref(state):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}


@pytest.mark.parametrize("bits", [32, 8])
def test_reference_checkpoint_restores_in_the_port(tmp_path, bits):
    rs, ps = tiny_state(bits)
    r_ckpt.save(rs, str(tmp_path), step=1)
    like = p_trainer.init_train_state(ps.params, p_opt.AdamWConfig(
        state_bits=bits))
    got = p_ckpt.restore(like, str(tmp_path))
    want = flat_ref(rs)
    flat = p_ckpt._flatten_with_paths(got)
    assert set(flat) == set(want)
    for key, leaf in flat.items():
        assert leaf.numpy().dtype == want[key].dtype, key
        assert leaf.numpy().shape == want[key].shape, key
        np.testing.assert_array_equal(leaf.numpy(), want[key], err_msg=key)


@pytest.mark.parametrize("bits", [32, 8])
def test_port_checkpoint_restores_in_the_reference(tmp_path, bits):
    rs, ps = tiny_state(bits)
    p_ckpt.save(ps, str(tmp_path), step=7)
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        keys = set(json.load(f)["leaves"])
    assert keys == set(flat_ref(rs))
    assert ".opt_state/.step" in keys and ".params/embed/table" in keys
    if bits == 8:
        assert ".opt_state/.m/embed/table/q" in keys
    assert r_ckpt.latest_step(str(tmp_path)) == 7
    got = r_ckpt.restore(rs, str(tmp_path))
    want = flat_ref(rs)
    for key, leaf in flat_ref(got).items():
        assert leaf.shape == want[key].shape and leaf.dtype == \
            want[key].dtype, key
        np.testing.assert_array_equal(leaf, want[key], err_msg=key)


def test_bf16_round_trip_and_the_reference_bytes(tmp_path):
    """bf16 leaves: the port restores its own bit for bit, and the bytes
    the reference writes for one (which the reference cannot restore)."""
    rng = np.random.default_rng(5)
    t = torch.from_numpy(rng.standard_normal((3, 17)).astype(np.float32)
                         ).to(torch.bfloat16)
    tree = {"w": t, "n": torch.arange(4, dtype=torch.int32),
            "s": [torch.tensor(2.5)]}
    p_ckpt.save(tree, str(tmp_path / "port"), step=3)
    meta = json.load(open(tmp_path / "port" / "step_00000003" /
                          "manifest.json"))["leaves"]
    assert meta["w"]["dtype"] == "bfloat16" and meta["s/0"]["dtype"] == \
        "float32"
    like = tree_map(torch.zeros_like, tree)
    got = p_ckpt.restore(like, str(tmp_path / "port"))
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), t.view(torch.int16))
    assert torch.equal(got["n"], tree["n"]) and got["s"][0].item() == 2.5
    r_ckpt.save({"w": jnp.asarray(t.to(torch.float32).numpy(),
                                  jnp.bfloat16)}, str(tmp_path / "ref"), 1)
    got = p_ckpt.restore({"w": torch.zeros_like(t)}, str(tmp_path / "ref"))
    assert torch.equal(got["w"].view(torch.int16), t.view(torch.int16))


def test_async_saver_copies_before_returning(tmp_path):
    """The host copy is taken on the calling thread: changing the tensors
    in place right after ``save`` returns does not reach the file."""
    x = torch.arange(6, dtype=torch.float32)
    saver = p_ckpt.AsyncSaver()
    saver.save({"x": x}, str(tmp_path), step=1)
    x.add_(100.0)
    saver.wait()
    got = p_ckpt.restore({"x": torch.zeros(6)}, str(tmp_path))
    assert torch.equal(got["x"], torch.arange(6, dtype=torch.float32))
    assert saver.last_path.endswith("step_00000001")


def test_checkpoint_gc_keeps_the_latest(tmp_path):
    for s in (1, 2, 3, 4):
        p_ckpt.save({"x": torch.tensor(float(s))}, str(tmp_path), s, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    assert p_ckpt.latest_step(str(tmp_path)) == 4
    assert p_ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        p_ckpt.restore({"x": torch.zeros(())}, str(tmp_path / "none"))


# --------------------------------------------------------------- fault loop

def tiny_setup():
    ocfg = p_opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=100)
    state = p_trainer.init_train_state(p_params(r_params()), ocfg)
    return state, p_trainer.make_train_step(p_loss(P_CFG), ocfg)


def batch_for(step):
    return lm_batch(step)[1]


def test_fault_loop_recovers(tmp_path):
    state, step = tiny_setup()
    cfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=5, max_restarts=3)
    loop = FaultTolerantLoop(step, cfg)
    final, metrics = loop.run(
        state, batch_for, num_steps=12,
        fail_at={7: RuntimeError("injected node failure")})
    assert loop.stats.restarts == 1
    assert loop.stats.steps_done >= 12
    assert np.isfinite(float(metrics["loss"]))
    state2, step2 = tiny_setup()
    for i in range(12):
        state2, m2 = step2(state2, batch_for(i))
    assert abs(float(metrics["loss"]) - float(m2["loss"])) < 5e-2
    assert p_ckpt.latest_step(str(tmp_path)) == 10


def test_fault_loop_gives_up_and_resumes(tmp_path):
    state, step = tiny_setup()
    cfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=2, max_restarts=1)
    loop = FaultTolerantLoop(step, cfg)
    with pytest.raises(RuntimeError, match="exceeded 1 restarts"):
        loop.run(state, batch_for, num_steps=6,
                 fail_at={1: ValueError("a"), 2: ValueError("b")})
    loop.saver.wait()
    assert loop.stats.restarts == 2
    assert p_ckpt.latest_step(str(tmp_path)) == 2
    loop2 = FaultTolerantLoop(step, cfg)            # resumes at step 2
    _, metrics = loop2.run(tiny_setup()[0], batch_for, num_steps=4)
    assert loop2.stats.steps_done == 2 and loop2.stats.restarts == 0
    assert np.isfinite(float(metrics["loss"]))


def test_train_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "starcoder2-3b", "--preset", "smoke", "--steps", "3", "--device",
         "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "arch=starcoder2-3b-smoke" in out.stdout
    assert "done: 3 steps" in out.stdout and "restarts=0" in out.stdout
    assert p_ckpt.latest_step(str(tmp_path)) == 2

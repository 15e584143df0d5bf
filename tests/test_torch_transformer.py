"""The port's transformer stack == the reference's, on the CPU.

Inputs are drawn with numpy from a seed and weights are the reference's,
carried by ``interop.transformer_params_from_arrays``; the reference runs
under ``jax.jit`` (configs static).  Tolerances: fp32 rtol 1e-4 with an
atol of 1e-5 (1e-4 on gradients, which sum over tokens); bf16 rtol 2e-2
and an atol of 2e-2 of the tensor's largest magnitude, a few bf16 steps
(2^-8 each) of it, since the two packages round elementwise bf16 ops at
different points and a residual stream of magnitude m carries steps of
m·2^-8 into every layer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as r_configs
import repro_torch.configs as p_configs
from repro.data import tokens as r_tokens
from repro.graphops import segment as r_seg
from repro.models import attention as r_attn
from repro.models import common as r_common
from repro.models import moe as r_moe
from repro.models import transformer as r_tfm
from repro_torch import interop
from repro_torch.data import tokens as p_tokens
from repro_torch.graphops import segment as p_seg
from repro_torch.models import attention as p_attn
from repro_torch.models import common as p_common
from repro_torch.models import moe as p_moe
from repro_torch.models import transformer as p_tfm
from repro_torch.models.common import tree_leaves

LM_ARCHS = ["yi-34b", "starcoder2-3b", "gemma-2b", "qwen2-moe-a2.7b",
            "qwen3-moe-235b-a22b"]
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
GRAD_TOL = (1e-4, 1e-4)
J_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, rtol, atol, what="", scaled=False):
    """``scaled``: ``atol`` is relative to ``max|want|`` (bf16)."""
    g, w = to_np(got), to_np(want)
    if scaled:
        atol = atol * max(float(np.abs(w).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


R_TRAIN = jit(lambda p, t, y, cfg: (r_tfm.forward(p, t, cfg),
                                     jax.value_and_grad(r_tfm.lm_loss)(
                                         p, t, y, cfg)), 3)
R_PREFILL = jit(r_tfm.prefill, 2, 3)
R_DECODE = jit(r_tfm.decode_step, 3)


def arrays(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def both(shape, seed=0, scale=1.0, dtype=torch.float32):
    """The same seeded normal draws as a jax and a torch array."""
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    return (jnp.asarray(a, J_DT[dtype]),
            torch.from_numpy(a).to(dtype))


def port_cfg(ref_cfg, dtype=None):
    """The port's counterpart of a reference TransformerConfig."""
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(p_tfm.TransformerConfig)}
    if ref_cfg.moe is not None:
        kw["moe"] = p_moe.MoEConfig(**{
            f.name: getattr(ref_cfg.moe, f.name)
            for f in dataclasses.fields(p_moe.MoEConfig)})
    kw["dtype"] = dtype or (torch.bfloat16 if ref_cfg.dtype == jnp.bfloat16
                            else torch.float32)
    return p_tfm.TransformerConfig(**kw)


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norms_mlp_embed(dtype):
    rtol, atol = TOL[dtype]
    xj, xt = both((3, 5, 24), 1, 2.0, dtype)
    gj, gt = both((24,), 2, 1.0, dtype)
    bj, bt = both((24,), 3, 1.0, dtype)
    close(p_common.rmsnorm({"g": gt}, xt), r_common.rmsnorm({"g": gj}, xj),
          rtol, atol, "rmsnorm")
    close(p_common.layernorm({"g": gt, "b": bt}, xt),
          r_common.layernorm({"g": gj, "b": bj}, xj), rtol, atol,
          "layernorm")
    pr = r_common.mlp_init(jax.random.PRNGKey(0), [24, 32, 8],
                           dtype=J_DT[dtype])
    pt = interop.transformer_params_from_arrays(arrays(pr), dtype, "cpu")
    close(p_common.mlp(pt, xt), r_common.mlp(pr, xj), rtol, atol, "mlp")
    ids = np.random.default_rng(4).integers(0, 40, (3, 7))
    tj, tt = both((40, 24), 5, 1.0, dtype)
    out = p_common.embed({"table": tt}, torch.from_numpy(ids))
    assert out.dtype == dtype
    close(out, r_common.embed({"table": tj}, jnp.asarray(ids)), 0, 0,
          "embed")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope(dtype):
    rtol, atol = TOL[dtype]
    cj, sj = r_common.rope_frequencies(16, 64, 10000.0)
    ct, st = p_common.rope_frequencies(16, 64, 10000.0, "cpu")
    close(ct, cj, 1e-5, 1e-6, "cos")
    close(st, sj, 1e-5, 1e-6, "sin")
    xj, xt = both((2, 3, 9, 16), 6, 1.0, dtype)
    pos = np.random.default_rng(7).integers(0, 64, (2, 1, 9))
    got = p_common.apply_rope(xt, ct, st, torch.from_numpy(pos))
    assert got.dtype == dtype
    close(got, r_common.apply_rope(xj, cj, sj, jnp.asarray(pos)), rtol,
          atol, "apply_rope")


def test_count_params_and_registry():
    assert list(p_configs.ARCHS) == list(r_configs.ARCHS)
    assert {a for a, s in p_configs.ARCHS.items()
            if s.family == "lm"} == set(LM_ARCHS)
    for arch in LM_ARCHS:
        for which in ("full", "smoke"):
            ref = getattr(r_configs.get_arch(arch), which)()
            assert getattr(p_configs.get_arch(arch), which)() == \
                port_cfg(ref), (arch, which)
            assert port_cfg(ref).param_count() == ref.param_count()
            assert port_cfg(ref).active_param_count() == \
                ref.active_param_count()
        cfg = p_configs.get_arch(arch).smoke()
        params = p_tfm.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
        rcfg = r_configs.get_arch(arch).smoke()
        ref = jax.eval_shape(lambda k: r_tfm.init_params(k, rcfg),
                             jax.random.PRNGKey(0))
        assert p_common.count_params(params) == sum(
            int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(ref))
        shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
        assert jax.tree_util.tree_map(
            lambda a: tuple(a.shape), params) == shapes, arch
    assert p_configs.get_arch("starcoder2-3b").full().param_count() == \
        4_161_985_536
    with pytest.raises(KeyError):
        p_configs.get_arch("no-such-arch")


def test_segment_ops():
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 7, 40)
    ids[ids == 3] = 4                            # segment 3 stays empty
    dj, dt = both((40, 5), 9)
    ij, it = jnp.asarray(ids), torch.from_numpy(ids)
    for name in ("segment_mean", "segment_std"):
        close(getattr(p_seg, name)(dt, it, 7),
              getattr(r_seg, name)(dj, ij, 7), 1e-5, 1e-6, name)
    close(p_seg.segment_mean(dt[:, 0], it, 7),
          r_seg.segment_mean(dj[:, 0], ij, 7), 1e-5, 1e-6, "mean 1-D")
    close(p_seg.segment_softmax(dt[:, 0], it, 7),
          r_seg.segment_softmax(dj[:, 0], ij, 7), 1e-5, 1e-7, "softmax")
    src = rng.integers(0, 6, 30)
    dst = rng.integers(0, 6, 30)
    cnt = rng.integers(1, 5, 30).astype(np.int32)
    want = r_seg.coalesce_pairs(jnp.asarray(src), jnp.asarray(dst),
                                jnp.asarray(cnt), 6)
    got = p_seg.coalesce_pairs(torch.from_numpy(src), torch.from_numpy(dst),
                               torch.from_numpy(cnt), 6)
    n = int(want[2])
    assert int(got[2]) == n
    np.testing.assert_array_equal(got[0].numpy()[:n], np.asarray(want[0])[:n])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("causal,q_offset", [(True, None), (False, None),
                                             (True, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_attention(causal, q_offset, dtype):
    rtol, atol = TOL[dtype]
    qj, qt = both((2, 6, 16, 8), 10, 1.0, dtype)
    kj, kt = both((2, 2, 48, 8), 11, 1.0, dtype)
    vj, vt = both((2, 2, 48, 8), 12, 1.0, dtype)
    want = r_attn.chunked_attention(qj, kj, vj, causal=causal, chunk=16,
                                    q_offset=q_offset)
    got = p_attn.chunked_attention(qt, kt, vt, causal=causal, chunk=16,
                                   q_offset=q_offset)
    assert got.dtype == dtype
    close(got, want, rtol, atol, "chunked_attention")
    close(p_attn.gqa_einsum_attention(qt, kt, vt, causal=causal),
          r_attn.gqa_einsum_attention(qj, kj, vj, causal=causal), rtol,
          atol, "gqa_einsum_attention")
    with pytest.raises(AssertionError):
        p_attn.chunked_attention(qt, kt, vt, chunk=20)


def test_chunked_attention_gradient():
    """Each chunk checkpointed when gradients are on: the gradient of q, k
    and v equals the reference's ``jax.grad`` through its scan."""
    qj, qt = both((1, 4, 32, 8), 13)
    kj, kt = both((1, 2, 32, 8), 14)
    vj, vt = both((1, 2, 32, 8), 15)
    wj, wt = both((1, 4, 32, 8), 16)

    def loss_r(q, k, v):
        return jnp.sum(r_attn.chunked_attention(q, k, v, chunk=8) * wj)

    want = jax.jit(jax.grad(loss_r, argnums=(0, 1, 2)))(qj, kj, vj)
    ts = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    loss = torch.sum(p_attn.chunked_attention(*ts, chunk=8) * wt)
    for g, w in zip(torch.autograd.grad(loss, ts), want):
        close(g, w, *GRAD_TOL, "chunked_attention gradient")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_ragged(dtype):
    rtol, atol = TOL[dtype]
    qj, qt = both((3, 6, 8), 17, 1.0, dtype)
    kj, kt = both((3, 2, 20, 8), 18, 1.0, dtype)
    vj, vt = both((3, 2, 20, 8), 19, 1.0, dtype)
    kv_len = np.array([1, 13, 20], np.int32)
    close(p_attn.decode_attention(qt, kt, vt, torch.from_numpy(kv_len)),
          r_attn.decode_attention(qj, kj, vj, jnp.asarray(kv_len)), rtol,
          atol, "decode_attention")
    valid = np.arange(20)[None, :] < kv_len[:, None]
    got = p_attn.decode_attention_partial(qt, kt, vt,
                                          torch.from_numpy(valid))
    want = r_attn.decode_attention_partial(qj, kj, vj, jnp.asarray(valid))
    for g, w, name in zip(got, want, ("num", "denom", "max")):
        close(g, w, rtol, atol, f"decode_attention_partial {name}")


# --------------------------------------------------------------------- MoE

@pytest.mark.parametrize("case", ["drops", "padded", "shared"])
def test_moe_apply(case):
    """Capacity drops (capacity factor 0.5: a quarter of the assignments
    at most fit), experts padded from 6 to 8 (never routed to), shared
    experts; output and aux loss, and the gradient of both."""
    kw = {"drops": dict(n_experts=4, top_k=2, d_ff_expert=16,
                        capacity_factor=0.5),
          "padded": dict(n_experts=6, top_k=2, d_ff_expert=16,
                         n_experts_alloc=8),
          "shared": dict(n_experts=4, top_k=3, d_ff_expert=8,
                         n_shared_experts=2, capacity_factor=1.0)}[case]
    rc, pc = r_moe.MoEConfig(**kw), p_moe.MoEConfig(**kw)
    rng = np.random.default_rng(3)
    E, D, Fe = rc.e_alloc, 12, rc.d_ff_expert
    shapes = {"router": {"w": (D, E)}, "wi": (E, D, Fe), "wg": (E, D, Fe),
              "wo": (E, Fe, D)}
    if rc.n_shared_experts:
        Fs = rc.n_shared_experts * Fe
        shapes["shared"] = {"wi": (D, Fs), "wg": (D, Fs), "wo": (Fs, D)}
    arr = jax.tree_util.tree_map(
        lambda sh: (rng.standard_normal(sh) / np.sqrt(sh[-2])).astype(
            np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    pr = jax.tree_util.tree_map(jnp.asarray, arr)
    pt = interop.transformer_params_from_arrays(arr, device="cpu")
    xj, xt = both((2, 10, 12), 20)

    def loss_r(p, x):
        o, a = r_moe.moe_apply(p, x, rc)
        return jnp.sum(o * o) + a, (o, a)

    (_, (out_r, aux_r)), gr = jax.jit(jax.value_and_grad(
        loss_r, argnums=(0, 1), has_aux=True))(pr, xj)
    out_p, aux_p = p_moe.moe_apply(pt, xt, pc)
    close(out_p, out_r, 1e-4, 1e-5, "moe out")
    close(aux_p, aux_r, 1e-5, 1e-7, "aux")
    if case == "padded":
        logits = (xt.reshape(-1, 12) @ pt["router"]["w"])
        probs = torch.softmax(p_moe._mask_padded(logits, pc), -1)
        assert float(probs[:, 6:].max()) == 0.0
    if case == "drops":          # some assignment was dropped at capacity
        T, K = 20, kw["top_k"]
        C = max(int(T * K * kw["capacity_factor"] / E), 1)
        idx = torch.topk(torch.softmax(xt.reshape(-1, 12)
                                       @ pt["router"]["w"], -1), K)[1]
        assert int(torch.bincount(idx.reshape(-1), minlength=E).max()) > C
    leaves = tree_leaves(pt)
    for t in leaves:
        t.requires_grad_(True)
    xg = xt.clone().requires_grad_(True)
    o, a = p_moe.moe_apply(pt, xg, pc)
    gs = torch.autograd.grad(torch.sum(o * o) + a, leaves + [xg])
    want = jax.tree_util.tree_leaves(gr[0]) + [gr[1]]
    for g, w in zip(gs, want):
        close(g, w, *GRAD_TOL, "moe gradient")


def test_mesh_paths_raise():
    """The XLA SPMD hints run as per-rank programs over a rank mesh
    (tests/test_torch_cells_multidevice): ``act_pspec`` needs the mesh
    (``mesh=``) and takes its two boundary forms only, ``mesh=`` without
    it is refused, and ``dispatch_pspec`` points ``moe_apply`` at its rank
    layer (``moe_sharded.moe_apply_pjit``); ``cp_mesh`` and
    ``MoEConfig.mesh`` run on a rank mesh and refuse any other object;
    ``prefill`` ignores ``cp_mesh``, as the reference's does."""
    from repro_torch.launch.mesh import make_meta_mesh
    cfg = dataclasses.replace(p_configs.get_arch("starcoder2-3b").smoke(),
                              act_pspec=("data", None, None))
    params = p_tfm.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="rank mesh"):
        p_tfm.forward(params, toks, cfg)
    with pytest.raises(ValueError, match="per-rank program"):
        p_tfm.forward(params, toks.to("meta"), cfg,
                      mesh=make_meta_mesh((1, 1)))
    plain = dataclasses.replace(cfg, act_pspec=None)
    with pytest.raises(ValueError, match="act_pspec"):
        p_tfm.forward(params, toks, plain, mesh=make_meta_mesh((1, 1)))
    cp = dataclasses.replace(plain, cp_mesh=object())
    with pytest.raises(TypeError, match="rank mesh"):
        p_tfm.forward(params, toks, cp)
    want, _ = p_tfm.prefill(params, toks, plain, 8)
    got, _ = p_tfm.prefill(params, toks, cp, 8)
    assert torch.equal(got, want)
    mc = p_moe.MoEConfig(n_experts=2, top_k=1, d_ff_expert=4, mesh=object())
    with pytest.raises(TypeError, match="rank mesh"):
        p_moe.moe_apply({}, torch.zeros((1, 2, 4)), mc)
    mc = p_moe.MoEConfig(n_experts=2, top_k=1, d_ff_expert=4,
                         dispatch_pspec=("model", "data", None))
    with pytest.raises(TypeError, match="moe_apply_pjit"):
        p_moe.moe_apply({}, torch.zeros((1, 2, 4)), mc)


# ------------------------------------------------------------ the LM stack

def ref_arrays(rcfg, seed=0):
    """Weights in the reference's tree (shapes from its ``init_params``),
    drawn with numpy as it draws them: norm gains 1, the embedding table
    N(0, 0.02²), every other weight N(0, 1/fan_in), fan_in its
    second-to-last axis."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: r_tfm.init_params(k, rcfg),
                            jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['g']"):
            return np.ones(leaf.shape, np.float32)
        scale = 0.02 if name.endswith("['table']") else \
            1.0 / np.sqrt(leaf.shape[-2])
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _lm_pair(arch, dtype=None, seed=0):
    """(reference config, port config, reference params, port params) on
    the same weights, in ``dtype`` (the config's own by default)."""
    rcfg = r_configs.get_arch(arch).smoke()
    if dtype is not None:
        rcfg = dataclasses.replace(rcfg, dtype=J_DT[dtype])
    pcfg = port_cfg(rcfg)
    arr = ref_arrays(rcfg, seed)
    pr = jax.tree_util.tree_map(lambda a: jnp.asarray(a, rcfg.dtype), arr)
    pt = interop.transformer_params_from_arrays(arr, pcfg.dtype, "cpu")
    return rcfg, pcfg, pr, pt


def _tokens(vocab, shape, seed=21):
    a = np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_loss_and_gradient(arch):
    rcfg, pcfg, pr, pt = _lm_pair(arch)
    tj, tt = _tokens(rcfg.vocab, (2, 16))
    yj, yt = _tokens(rcfg.vocab, (2, 16), 22)
    (lr, ar), (loss_r, gr) = R_TRAIN(pr, tj, yj, rcfg)
    lp, ap = p_tfm.forward(pt, tt, pcfg)
    close(lp, lr, 1e-4, 1e-5, "logits")
    close(ap, ar, 1e-4, 1e-7, "aux")
    leaves = tree_leaves(pt)
    for t in leaves:
        t.requires_grad_(True)
    loss = p_tfm.lm_loss(pt, tt, yt, pcfg)
    close(loss, loss_r, 1e-5, 1e-6, "lm_loss")
    gs = torch.autograd.grad(loss, leaves)
    for g, w in zip(gs, jax.tree_util.tree_leaves(gr)):
        close(g, w, *GRAD_TOL, f"{arch} gradient")


def test_lm_remat_gradient_equals_plain():
    """``remat`` (each layer checkpointed) changes memory, not values."""
    rcfg, pcfg, pr, pt = _lm_pair("starcoder2-3b")
    tt = _tokens(rcfg.vocab, (2, 16))[1]
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(pcfg, remat=remat)
        params = p_common.tree_map(
            lambda t: t.detach().clone().requires_grad_(True), pt)
        leaves = tree_leaves(params)
        grads.append(torch.autograd.grad(
            p_tfm.lm_loss(params, tt, tt, cfg), leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_and_decode(arch):
    rcfg, pcfg, pr, pt = _lm_pair(arch)
    _lm_serve_check(rcfg, pcfg, pr, pt, *TOL[torch.float32], False)


def test_lm_prefill_and_decode_bf16():
    rcfg, pcfg, pr, pt = _lm_pair("starcoder2-3b", torch.bfloat16)
    assert pcfg.dtype == torch.bfloat16 and pt["embed"]["table"].dtype == \
        torch.bfloat16
    _lm_serve_check(rcfg, pcfg, pr, pt, *TOL[torch.bfloat16], True)


def _lm_serve_check(rcfg, pcfg, pr, pt, rtol, atol, scaled):
    tj, tt = _tokens(rcfg.vocab, (2, 16))
    lr, cr = R_PREFILL(pr, tj, rcfg, 24)
    with torch.no_grad():
        lp, cp = p_tfm.prefill(pt, tt, pcfg, max_len=24)
        assert tuple(cp["k"].shape) == tuple(cr["k"].shape)
        for key in ("k", "v"):
            close(cp[key], cr[key], rtol, atol, f"prefill cache {key}",
                  scaled)
        close(lp, lr, rtol, atol, "prefill logits", scaled)
        np.testing.assert_array_equal(cp["len"].numpy(), np.asarray(cr["len"]))
        # the rows of a batch at different lengths: row 1 steps ahead alone
        cr["len"] = cr["len"].at[1].set(9)
        cp["len"][1] = 9
        for step in range(3):
            nxt = np.asarray(jnp.argmax(lr, -1)).astype(np.int32)
            lr, cr = R_DECODE(pr, jnp.asarray(nxt), cr, rcfg)
            lp, cp = p_tfm.decode_step(pt, torch.from_numpy(nxt), cp, pcfg)
            close(lp, lr, rtol, atol, f"decode logits, step {step}", scaled)
            for key in ("k", "v"):
                close(cp[key], cr[key], rtol, atol, f"decode {key} {step}",
                      scaled)
            np.testing.assert_array_equal(cp["len"].numpy(),
                                          np.asarray(cr["len"]))


def test_decode_past_max_len_writes_nothing():
    """A row at ``len == max_len`` writes no key (the reference's one-hot
    is all zeros there) and reads RoPE at the last position (its gather
    clamps)."""
    rcfg, pcfg, pr, pt = _lm_pair("starcoder2-3b")
    tj, tt = _tokens(rcfg.vocab, (2, 6))
    _, cr = R_PREFILL(pr, tj, rcfg, 8)
    with torch.no_grad():
        _, cp = p_tfm.prefill(pt, tt, pcfg, max_len=8)
        cr["len"] = jnp.asarray([8, 9], jnp.int32)
        cp["len"] = torch.tensor([8, 9], dtype=torch.int32)
        tok = np.array([3, 5], np.int32)
        lr, cr2 = R_DECODE(pr, jnp.asarray(tok), cr, rcfg)
        lp, cp2 = p_tfm.decode_step(pt, torch.from_numpy(tok), cp, pcfg)
    close(lp, lr, 1e-4, 1e-5, "logits past max_len")
    assert torch.equal(cp2["k"], cp["k"])


# ------------------------------------------------------------------ tokens

def test_token_batch_equal():
    for step, rank, world in ((0, 0, 1), (3, 1, 2), (7, 3, 4)):
        want = r_tokens.token_batch(step, 8, 16, 101, rank=rank,
                                    world=world, seed=5)
        got = p_tokens.token_batch(step, 8, 16, 101, rank=rank,
                                   world=world, seed=5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_prefetcher():
    pf = p_tokens.Prefetcher(lambda s: p_tokens.token_batch(s, 4, 8, 101),
                             depth=2)
    try:
        b0, b1 = pf.next(), pf.next()
    finally:
        pf.close()
    np.testing.assert_array_equal(b0[0], r_tokens.token_batch(0, 4, 8,
                                                              101)[0])
    np.testing.assert_array_equal(b1[0], r_tokens.token_batch(1, 4, 8,
                                                              101)[0])

"""The port's multi-device layer against the reference's ``shard_map``
layers, on a 2 data x 4 model mesh of the CPU.

One module fixture runs both sides at once: the reference in two
subprocesses with 8 forced host devices each (they write their outputs
and gradients to ``.npz`` files), and the port as 8 gloo ranks started by
``launch.spawn.spawn`` (rank 0 gathers every result).  Both read the same
seeded numpy inputs.  The checks below compare the cached results:

  * MOE_SHARDED: expert-parallel MoE, with and without drops, with and
    without ``seq_sharded``, and qwen2-moe's smoke MoE (6 experts padded
    to 8, shared experts), forward and gradients held to the reference's
    sharded run (each peer drops by its own capacity), and to
    ``moe_apply`` where nothing drops;
  * PNA_SHARDED, CP_ATTENTION, COMBINE_PARTIALS, TRANSFORMER_CP,
    MIND_LOGITS: each held to the reference's single-device function (and
    PNA and attention to its sharded run too);
  * COMPRESSED_PSUM: int8 codes and residuals exact against a numpy
    oracle of the formula, the mean within the reference's bound;
  * COMPRESSED_DP_STEP: 3 steps of the 2-rank group step == the
    one-process ``make_compressed_dp_step(n_shards=2)``, bit for bit;
  * REMESH: every rank's blocks reassemble to the tree exactly.

Tolerances are the reference's own test's: rtol = atol = 2e-4 in fp32.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
MESH = (2, 4)
TOL = dict(rtol=2e-4, atol=2e-4)
# (param set, capacity_factor, seq_sharded); "moe" is the reference
# test's layer (8 experts top-2, d 32), "qwen" qwen2-moe-a2.7b.smoke()'s
# MoE (6 experts top-4, 4 shared) padded to 8 experts on the 4-way axis
MOE_CASES = {
    "cf8": ("moe", 8.0, False), "cf8_seq": ("moe", 8.0, True),
    "cf1": ("moe", 1.0, False), "cf1_seq": ("moe", 1.0, True),
    "qwen_padded": ("qwen", 2.0, False),
}
NO_DROP = ("cf8", "cf8_seq")
# "moe" takes 4 x 64 tokens, so that a peer's 32 tokens overflow its
# capacity at capacity factor 1 (C_loc = 8; at 4 x 8 tokens the floor of
# 4 slots holds every token)
MOE_PARAMS = {"moe": dict(d=32, seq=64, n_experts=8, top_k=2,
                          d_ff_expert=16, n_shared_experts=0, alloc=0),
              "qwen": dict(d=64, seq=8, n_experts=6, top_k=4,
                           d_ff_expert=32, n_shared_experts=4, alloc=8)}


# ------------------------------------------------------------------ inputs

def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree.detach().numpy() if isinstance(
        tree, torch.Tensor) else np.asarray(tree)}


def _unflatten(flat, prefix):
    """The nested dict (lists where every key is a digit) under
    ``prefix/`` of a flat ``{"a/b/0/c": array}`` mapping."""
    root: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return fix(root)


def _moe_param_arrays(rng, d, n_experts, d_ff_expert, n_shared_experts,
                      alloc, **_):
    """One MoE layer's weights, drawn as ``moe_init`` scales them."""
    E, Fe = alloc or n_experts, d_ff_expert
    p = {"router": {"w": rng.standard_normal((d, E)) / d ** 0.5},
         "wi": rng.standard_normal((E, d, Fe)) / d ** 0.5,
         "wg": rng.standard_normal((E, d, Fe)) / d ** 0.5,
         "wo": rng.standard_normal((E, Fe, d)) / Fe ** 0.5}
    if n_shared_experts:
        Fs = n_shared_experts * Fe
        p["shared"] = {"wi": rng.standard_normal((d, Fs)) / d ** 0.5,
                       "wg": rng.standard_normal((d, Fs)) / d ** 0.5,
                       "wo": rng.standard_normal((Fs, d)) / Fs ** 0.5}
    return p


def make_inputs():
    """Every input of both sides, as one flat dict of numpy arrays."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.gnn import pna
    from repro_torch.models.recsys import mind

    rng = np.random.default_rng(0)
    f32 = np.float32
    flat = {}
    for name, kw in MOE_PARAMS.items():
        p = _moe_param_arrays(rng, **kw)
        flat.update({k: v.astype(f32) for k, v in
                     _flatten(p, f"{name}_p/").items()})
        shape = (4, kw["seq"], kw["d"])
        flat[f"{name}_x"] = rng.standard_normal(shape).astype(f32)
        flat[f"{name}_ct"] = rng.standard_normal(shape).astype(f32)
    # PNA: the reference test's graph
    N, D, E = 64, 16, 256
    flat["pna_src"] = rng.integers(0, N, E).astype(np.int32)
    flat["pna_dst"] = rng.integers(0, N, E).astype(np.int32)
    flat["pna_feat"] = rng.standard_normal((N, D)).astype(f32)
    flat["pna_labels"] = rng.integers(0, 4, N).astype(np.int32)
    pcfg = pna.PNAConfig(n_layers=2, d_hidden=16, d_in=D, n_classes=4,
                         avg_degree=4.0)
    flat.update(_flatten(pna.init_params(torch.Generator().manual_seed(2),
                                         pcfg, device="cpu"), "pna_p/"))
    # attention: the reference test's shapes
    flat["attn_q"] = rng.standard_normal((2, 6, 32, 8)).astype(f32)
    flat["attn_k"] = rng.standard_normal((2, 2, 32, 8)).astype(f32)
    flat["attn_v"] = rng.standard_normal((2, 2, 32, 8)).astype(f32)
    flat["attn_ct"] = rng.standard_normal((2, 6, 32, 8)).astype(f32)
    flat["dec_q"] = rng.standard_normal((2, 4, 8)).astype(f32)
    flat["dec_k"] = rng.standard_normal((2, 2, 32, 8)).astype(f32)
    flat["dec_v"] = rng.standard_normal((2, 2, 32, 8)).astype(f32)
    flat["dec_len"] = np.array([20, 32], np.int32)
    # yi-34b smoke, 4 x 32 tokens
    ycfg = get_arch("yi-34b").smoke()
    flat.update(_flatten(tfm.init_params(torch.Generator().manual_seed(3),
                                         ycfg, device="cpu"), "yi_p/"))
    flat["yi_tokens"] = rng.integers(0, ycfg.vocab, (4, 32)).astype(np.int32)
    flat["yi_targets"] = rng.integers(0, ycfg.vocab, (4, 32)).astype(
        np.int32)
    # MIND smoke, batch 16
    mcfg = get_arch("mind").smoke()
    flat.update(_flatten(mind.init_params(torch.Generator().manual_seed(4),
                                          mcfg, device="cpu"), "mind_p/"))
    flat["mind_hist"] = rng.integers(0, mcfg.n_items, (16, mcfg.hist_len)
                                     ).astype(np.int32)
    flat["mind_mask"] = rng.random((16, mcfg.hist_len)) < 0.8
    flat["mind_mask"][:, 0] = True
    flat["mind_target"] = rng.integers(0, mcfg.n_items, 16).astype(np.int32)
    flat["psum_x"] = rng.standard_normal((8, 64)).astype(f32)
    # the compressed step: starcoder2-3b smoke, 3 batches of 4 x 16
    scfg = get_arch("starcoder2-3b").smoke()
    flat.update(_flatten(tfm.init_params(torch.Generator().manual_seed(5),
                                         scfg, device="cpu"), "dp_p/"))
    flat["dp_tokens"] = rng.integers(0, scfg.vocab, (3, 4, 16)).astype(
        np.int32)
    flat["dp_targets"] = rng.integers(0, scfg.vocab, (3, 4, 16)).astype(
        np.int32)
    return flat


# --------------------------------------------------------- the reference

REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.utils.compat import shard_map

inp = dict(np.load(sys.argv[1]))
out = {}
# Auto axes, as jax.make_mesh gave them before explicit sharding became its
# default: under Explicit axes the sharded PNA loss's gradient does not
# trace on jax 0.9 (an ambiguous contraction over a sharded dim)
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)


def tree(prefix):
    root = {}
    for key, val in inp.items():
        if key.startswith(prefix + "/"):
            node = root
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(val)
    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return fix(root)


def save(prefix, t):
    for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[f"{prefix}/{key}" if key else prefix] = np.asarray(leaf)


# ---- MoE
from repro.models.moe import MoEConfig, moe_apply
for case, (pset, cf, seq) in CASES.items():
    kw = PARAMS[pset]
    cfg = MoEConfig(n_experts=kw["n_experts"], top_k=kw["top_k"],
                    d_ff_expert=kw["d_ff_expert"],
                    n_shared_experts=kw["n_shared_experts"],
                    capacity_factor=cf, n_experts_alloc=kw["alloc"])
    p, x = tree(f"{pset}_p"), jnp.asarray(inp[f"{pset}_x"])
    ct = jnp.asarray(inp[f"{pset}_ct"])
    runs = {"sharded": dataclasses.replace(cfg, mesh=mesh, seq_sharded=seq)}
    if case in NO_DROP:
        runs["single"] = cfg
    for kind, c in runs.items():
        def loss(pp, xx, c=c):
            o, aux = moe_apply(pp, xx, c)
            return jnp.sum(o * ct) + aux, (o, aux)
        with mesh:
            (_, (o, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p, x)
        save(f"moe/{case}/{kind}/out", o)
        save(f"moe/{case}/{kind}/aux", aux)
        save(f"moe/{case}/{kind}/grad", gp)
        save(f"moe/{case}/{kind}/grad/x", gx)

# ---- PNA
from repro.models.gnn import pna
from repro.models.gnn.graphdata import GraphBatch
from repro.graphops.distributed import partition_edges_by_dst
src, dst = inp["pna_src"], inp["pna_dst"]
N = inp["pna_feat"].shape[0]
cfg_p = pna.PNAConfig(n_layers=2, d_hidden=16, d_in=16, n_classes=4,
                      avg_degree=4.0)
params = tree("pna_p")
def gb_of(s, d, m):
    return GraphBatch(node_feat=jnp.asarray(inp["pna_feat"]),
                      edge_src=jnp.asarray(s), edge_dst=jnp.asarray(d),
                      edge_mask=jnp.asarray(m), node_mask=jnp.ones(N, bool),
                      graph_id=jnp.zeros(N, jnp.int32), positions=None,
                      labels=jnp.asarray(inp["pna_labels"]))
perm, emask, _ = partition_edges_by_dst(src, dst, N, 8)
runs = {"single": (cfg_p, gb_of(src, dst, np.ones(len(src), bool))),
        "sharded": (dataclasses.replace(cfg_p, mesh=mesh,
                                        shard_axes=("data", "model")),
                    gb_of(src[perm], dst[perm], emask))}
for kind, (c, gb) in runs.items():
    def loss(pp, gg, c=c):
        return pna.loss_fn(pp, gg, c), pna.forward(pp, gg, c)
    with mesh:
        (l, o), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params, gb)
    save(f"pna/{kind}/out", o)
    save(f"pna/{kind}/loss", l)
    save(f"pna/{kind}/grad", g)

# ---- context-parallel attention, split-KV combine
from repro.models import attention as attn
q, k, v, ct = (jnp.asarray(inp[f"attn_{n}"]) for n in ("q", "k", "v", "ct"))
for causal in (True, False):
    fns = {"single": lambda a, b, c: attn.chunked_attention(
               a, b, c, causal=causal, chunk=8),
           "sharded": lambda a, b, c: attn.context_parallel_attention(
               a, b, c, mesh, data_axes=("data",), causal=causal, chunk=8)}
    for kind, fn in fns.items():
        def loss(a, b, c, fn=fn):
            o = fn(a, b, c)
            return jnp.sum(o * ct), o
        with mesh:
            grads, o_val = jax.jit(jax.grad(loss, argnums=(0, 1, 2),
                                            has_aux=True))(q, k, v)
        tag = f"cp/{'causal' if causal else 'full'}/{kind}"
        save(f"{tag}/out", o_val)
        for n, gg in zip("qkv", grads):
            save(f"{tag}/grad/{n}", gg)
dq, dk, dv = (jnp.asarray(inp[f"dec_{n}"]) for n in "qkv")
dlen = jnp.asarray(inp["dec_len"])
save("dec/single", attn.decode_attention(dq, dk, dv, dlen))
valid = jnp.arange(dk.shape[2])[None, :] < dlen[:, None]
def split(qq, kk, vv, mm):
    return attn.combine_partials(*attn.decode_attention_partial(
        qq, kk, vv, mm), "model")
with mesh:
    save("dec/sharded", jax.jit(shard_map(
        split, mesh=mesh,
        in_specs=(P(), P(None, None, "model", None),
                  P(None, None, "model", None), P(None, "model")),
        out_specs=P(), check_vma=False))(dq, dk, dv, valid))

# ---- yi-34b smoke: forward without a mesh, and with cp_mesh
from repro.configs import get_arch
from repro.models import transformer as tfm
ycfg = get_arch("yi-34b").smoke()
yp = tree("yi_p")
tok, tgt = jnp.asarray(inp["yi_tokens"]), jnp.asarray(inp["yi_targets"])
logits, loss = jax.jit(lambda p, t, y: (tfm.forward(p, t, ycfg)[0],
                                         tfm.lm_loss(p, t, y, ycfg)))(
    yp, tok, tgt)
save("yi/single/logits", logits)
save("yi/single/loss", loss)
ycp = dataclasses.replace(ycfg, cp_mesh=mesh, cp_data_axes=("data",))
with mesh:
    save("yi/sharded/logits", jax.jit(
        lambda p, t: tfm.forward(p, t, ycp)[0])(yp, tok))

# ---- MIND smoke, single device
from repro.models.recsys import mind
mcfg = get_arch("mind").smoke()
mp_ = tree("mind_p")
batch = {"hist": jnp.asarray(inp["mind_hist"]),
         "hist_mask": jnp.asarray(inp["mind_mask"]),
         "target": jnp.asarray(inp["mind_target"])}
l, g = jax.jit(jax.value_and_grad(lambda p, b: mind.train_loss(p, b, mcfg)))(
    mp_, batch)
save("mind/single/loss", l)
save("mind/single/grad", g)

# ---- compressed psum over the data axis (out_specs kept per shard)
from repro.train.compression import compressed_psum
xs = jnp.asarray(inp["psum_x"])
with mesh:
    val, resid = jax.jit(shard_map(
        lambda x: compressed_psum(x, "data"), mesh=mesh,
        in_specs=P("data", None), out_specs=(P("data", None), P("data", None)),
        check_vma=False))(xs)
save("psum/val", np.asarray(val))
save("psum/resid", np.asarray(resid))
np.savez(sys.argv[2], **out)
print("REFERENCE_DONE")
'''


def _reference_scripts() -> list:
    """The reference run as two scripts, the MoE cases and the rest, run
    side by side (each jit compile is a few hundred ms of one core)."""
    head, _, body = REFERENCE.partition("# ---- MoE\n")
    moe, _, rest = body.partition("# ---- PNA\n")
    rest, _, tail = rest.partition("np.savez(sys.argv[2], **out)\n")
    tail = "np.savez(sys.argv[2], **out)\n" + tail
    consts = (f"CASES = {MOE_CASES!r}\nNO_DROP = {NO_DROP!r}\n"
              f"PARAMS = {MOE_PARAMS!r}\n")
    return [consts + head + moe + tail, consts + head + rest + tail]


# -------------------------------------------------------------- the port

def port_ranks(rank, world_size, init_method, inputs_path):
    """One rank of the port on the 2 x 4 mesh; rank 0 returns every
    result gathered (numpy), the others None."""
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.launch import collectives as C
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import (
        tree_leaves, tree_map, tree_unflatten,
    )
    from repro_torch.models.gnn import pna
    from repro_torch.models.gnn.graphdata import GraphBatch
    from repro_torch.models.moe import MoEConfig, moe_apply
    from repro_torch.models.moe_sharded import expert_spec
    from repro_torch.models.recsys import mind
    from repro_torch.graphops.distributed import partition_edges_by_dst
    from repro_torch.train import optimizer as opt
    from repro_torch.train.fault import remesh
    from repro_torch.train.trainer import (
        init_train_state, make_compressed_dp_step,
    )

    inp = dict(np.load(inputs_path))
    mesh = make_rank_mesh(world_size, rank, init_method, MESH,
                          ("data", "model"), backend="gloo", devices="cpu")
    out = {}

    def t(name):
        return torch.from_numpy(inp[name])

    def save(prefix, tree):
        for k, v in _flatten(tree, prefix + "/").items():
            out[k] = v

    def grads_of(loss, leaves, specs):
        """Each leaf's gradient of the global loss, gathered full."""
        gs = torch.autograd.grad(loss, leaves)
        return [S.gather_full(S.sum_over_replicas(g, sp, mesh), sp, mesh)
                for g, sp in zip(gs, specs)]

    # ---- MoE
    wspec = expert_spec(("data",), "model")
    for case, (pset, cf, seq) in MOE_CASES.items():
        kw = MOE_PARAMS[pset]
        cfg = MoEConfig(n_experts=kw["n_experts"], top_k=kw["top_k"],
                        d_ff_expert=kw["d_ff_expert"],
                        n_shared_experts=kw["n_shared_experts"],
                        capacity_factor=cf, n_experts_alloc=kw["alloc"],
                        mesh=mesh, seq_sharded=seq)
        full = interop.transformer_params_from_arrays(
            _unflatten(inp, f"{pset}_p"), device="cpu")
        xspec = ("data", "model" if seq else None, None)
        specs = {k: (wspec if k in ("wi", "wg", "wo") else
                     tree_map(lambda _: (), v)) for k, v in full.items()}
        p = {k: (S.local_block(v, specs[k], mesh) if k in ("wi", "wg", "wo")
                 else v) for k, v in full.items()}
        p = tree_map(lambda a: a.detach().clone().requires_grad_(), p)
        x = S.local_block(t(f"{pset}_x"), xspec, mesh).clone(
            ).requires_grad_()
        ct = S.local_block(t(f"{pset}_ct"), xspec, mesh)
        o, aux = moe_apply(p, x, cfg)
        loss = (torch.sum(o * ct) / S.n_replicas(xspec, mesh)
                + aux / mesh.size)
        gs = grads_of(loss, tree_leaves(p) + [x],
                      S.spec_leaves(specs) + [xspec])
        save(f"moe/{case}/out", S.gather_full(o, xspec, mesh))
        save(f"moe/{case}/aux", aux)
        save(f"moe/{case}/grad", tree_unflatten(p, gs[:-1]))
        save(f"moe/{case}/grad/x", gs[-1])

    # ---- PNA over all 8 ranks
    axes = ("data", "model")
    src, dst = inp["pna_src"], inp["pna_dst"]
    N = inp["pna_feat"].shape[0]
    perm, emask, _ = partition_edges_by_dst(src, dst, N, mesh.size)
    nspec, espec = (axes, None), (axes,)
    gb = GraphBatch(
        node_feat=S.local_block(t("pna_feat"), nspec, mesh),
        edge_src=S.local_block(torch.from_numpy(src[perm]), espec, mesh),
        edge_dst=S.local_block(torch.from_numpy(dst[perm]), espec, mesh),
        edge_mask=S.local_block(torch.from_numpy(emask), espec, mesh),
        node_mask=torch.ones(N // mesh.size, dtype=torch.bool),
        graph_id=torch.zeros(N // mesh.size, dtype=torch.int32),
        labels=S.local_block(t("pna_labels"), espec, mesh))
    pcfg = pna.PNAConfig(n_layers=2, d_hidden=16, d_in=16, n_classes=4,
                         avg_degree=4.0, mesh=mesh, shard_axes=axes)
    pp = interop.pna_params_from_arrays(_unflatten(inp, "pna_p"),
                                        device="cpu")
    pp = tree_map(lambda a: a.requires_grad_(), pp)
    save("pna/out", S.gather_full(pna.forward(pp, gb, pcfg), nspec, mesh))
    loss = pna.loss_fn(pp, gb, pcfg)
    gs = grads_of(loss / mesh.size, tree_leaves(pp),
                  [()] * len(tree_leaves(pp)))
    save("pna/loss", loss)
    save("pna/grad", tree_unflatten(pp, gs))

    # ---- context-parallel attention
    aspec = ("data", None, "model", None)
    for causal in (True, False):
        q, k, v = (S.local_block(t(f"attn_{n}"), aspec, mesh).clone(
            ).requires_grad_() for n in "qkv")
        o = attn.context_parallel_attention(q, k, v, mesh, causal=causal,
                                            chunk=8)
        ct = S.local_block(t("attn_ct"), aspec, mesh)
        gs = grads_of(torch.sum(o * ct), [q, k, v], [aspec] * 3)
        tag = f"cp/{'causal' if causal else 'full'}"
        save(f"{tag}/out", S.gather_full(o, aspec, mesh))
        for n, g in zip("qkv", gs):
            save(f"{tag}/grad/{n}", g)
    dq, dk, dv = t("dec_q"), t("dec_k"), t("dec_v")
    dlen = t("dec_len")
    valid = torch.arange(dk.shape[2])[None, :] < dlen[:, None]
    kvspec = (None, None, "model", None)
    parts = attn.decode_attention_partial(
        dq, S.local_block(dk, kvspec, mesh), S.local_block(dv, kvspec, mesh),
        S.local_block(valid, (None, "model"), mesh))
    save("dec/sharded", attn.combine_partials(*parts, "model", mesh))
    save("dec/single", attn.decode_attention(dq, dk, dv, dlen))

    # ---- yi-34b smoke with cp_mesh
    ycfg = dataclasses.replace(get_arch("yi-34b").smoke(), cp_mesh=mesh,
                               cp_data_axes=("data",))
    yp = interop.transformer_params_from_arrays(_unflatten(inp, "yi_p"),
                                                device="cpu")
    bspec = ("data", None)
    tok = S.local_block(t("yi_tokens"), bspec, mesh)
    tgt = S.local_block(t("yi_targets"), bspec, mesh)
    with torch.no_grad():
        logits, _ = tfm.forward(yp, tok, ycfg)
        save("yi/logits", S.gather_full(logits, ("data", None, None), mesh))
        save("yi/loss", tfm.lm_loss(yp, tok, tgt, ycfg))

    # ---- MIND smoke with logits_pspec over the data axis
    mcfg = dataclasses.replace(get_arch("mind").smoke(),
                               logits_pspec=("data", None))
    mpar = interop.mind_params_from_arrays(_unflatten(inp, "mind_p"),
                                           device="cpu")
    mpar = tree_map(lambda a: a.requires_grad_(), mpar)
    batch = {"hist": S.local_block(t("mind_hist"), bspec, mesh),
             "hist_mask": S.local_block(t("mind_mask"), bspec, mesh),
             "target": S.local_block(t("mind_target"), ("data",), mesh)}
    loss = mind.train_loss(mpar, batch, mcfg, mesh)
    gs = grads_of(loss / mesh.size, tree_leaves(mpar),
                  [()] * len(tree_leaves(mpar)))
    save("mind/loss", loss)
    save("mind/grad", tree_unflatten(mpar, gs))

    # ---- compressed psum over the data axis
    from repro_torch.train.compression import (
        compressed_psum_axis, quantize_int8_axis,
    )
    xl = S.local_block(t("psum_x"), ("data", None), mesh)
    q, _ = quantize_int8_axis(xl, "data", mesh)
    val, resid = compressed_psum_axis(xl, "data", mesh)
    for name, a in (("codes", q), ("val", val), ("resid", resid)):
        save(f"psum/{name}", S.gather_full(a, ("data", None), mesh))

    # ---- the compressed step: 2 data ranks (model peers replicate)
    scfg = get_arch("starcoder2-3b").smoke()
    ocfg = opt.AdamWConfig()

    def lm(p, b):
        return tfm.lm_loss(p, b[0], b[1], scfg)

    def params():
        return interop.transformer_params_from_arrays(
            _unflatten(inp, "dp_p"), device="cpu")

    state = init_train_state(params(), ocfg, compressed_dp=True)
    step = make_compressed_dp_step(lm, ocfg, mesh=mesh, data_axis="data")
    losses = []
    for i in range(3):
        b = (S.local_block(t("dp_tokens")[i], bspec, mesh),
             S.local_block(t("dp_targets")[i], bspec, mesh))
        state, m = step(state, b)
        losses.append(m["loss"])
    ef = tree_map(lambda e: C.all_gather(e[None], "data", mesh, axis=0),
                  state.ef)
    if rank == 0:
        twin = init_train_state(params(), ocfg, compressed_dp=True,
                                n_shards=2)
        step2 = make_compressed_dp_step(lm, ocfg, n_shards=2)
        twin_losses = []
        for i in range(3):
            twin, m = step2(twin, (t("dp_tokens")[i], t("dp_targets")[i]))
            twin_losses.append(m["loss"])
        out["dp/params_equal"] = np.array(all(
            torch.equal(a, b) for a, b in zip(tree_leaves(state.params),
                                              tree_leaves(twin.params))))
        out["dp/ef_equal"] = np.array(all(
            torch.equal(a, b) for a, b in zip(tree_leaves(ef),
                                              tree_leaves(twin.ef))))
        out["dp/moments_equal"] = np.array(all(
            torch.equal(a, b) for a, b in zip(
                tree_leaves(state.opt_state), tree_leaves(twin.opt_state))))
        out["dp/loss"] = torch.stack(losses).numpy()
        out["dp/twin_loss"] = torch.stack(twin_losses).numpy()
        out["dp/ef_nonzero"] = np.array(
            sum(int(torch.count_nonzero(e)) for e in tree_leaves(ef)))

    # ---- remesh: a host tree onto this rank by the sharding rules
    host_tree = interop.transformer_params_from_arrays(
        _unflatten(inp, "yi_p"), device="cpu")
    specs = S.params_shardings(host_tree, mesh)
    blocks = remesh(host_tree, specs=specs, mesh=mesh)
    back = [S.gather_full(b, sp, mesh) for b, sp in zip(
        tree_leaves(blocks), S.spec_leaves(specs))]
    out["remesh/equal"] = np.array(all(
        torch.equal(a, b) for a, b in zip(back, tree_leaves(host_tree))))
    out["remesh/sharded_leaves"] = np.array(sum(
        b.numel() < a.numel() for a, b in zip(tree_leaves(host_tree),
                                               tree_leaves(blocks))))
    out["counts"] = np.array(str(mesh.counts))
    return out if rank == 0 else None


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference, port) result dicts, both runs started together."""
    from repro_torch.launch.spawn import spawn
    tmp = tmp_path_factory.mktemp("multidevice")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **make_inputs())
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    outs = [tmp / f"reference{i}.npz" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(inputs), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for script, out in zip(_reference_scripts(), outs)]
    ref = {}
    try:
        port = spawn(port_ranks, 8, str(inputs), timeout=120.0)[0]
        for proc, out in zip(procs, outs):
            log, _ = proc.communicate(timeout=150)
            assert proc.returncode == 0, log[-4000:]
            ref.update(np.load(out))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ref, port


def close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **tol)


def matching(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items()
            if k.startswith(prefix)}


# ------------------------------------------------------------------ checks

@pytest.mark.parametrize("what", ["out", "aux", "grad"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_sharded_equals_the_reference_sharded_run(results, case, what):
    """MOE_SHARDED: the reference's sharded run, drops included (each peer
    drops by its own capacity, so only this run is the same function)."""
    ref, port = results
    want = matching(ref, f"moe/{case}/sharded/{what}")
    got = matching(port, f"moe/{case}/{what}")
    assert want and set(got) == set(want)
    for k in want:
        close(got[k], want[k], f"moe {case} {what}{k}")


@pytest.mark.parametrize("what", ["out", "grad"])
@pytest.mark.parametrize("case", NO_DROP)
def test_moe_sharded_without_drops_equals_moe_apply(results, case, what):
    """Where nothing drops, the sharded layer is ``moe_apply``'s function,
    but for its aux loss: the mean of each peer's load-balance loss over
    its own tokens.  The router's gradient carries that term, so it is
    held to the sharded run only (above)."""
    ref, port = results
    want = matching(ref, f"moe/{case}/single/{what}")
    want.pop("/router/w", None)
    assert want
    for k, w in want.items():
        close(port[f"moe/{case}/{what}{k}"], w, f"moe {case} {what}{k}")


def test_moe_drops_part_the_sharded_layer_from_moe_apply(results):
    """At capacity factor 1 the reference's sharded layer is not
    ``moe_apply``: the cases above hold the port to the right run."""
    ref, port = results
    a, b = ref["moe/cf1/sharded/out"], ref["moe/cf8/sharded/out"]
    assert np.abs(a - b).max() > 1e-2
    assert np.abs(port["moe/cf1/out"] - b).max() > 1e-2


@pytest.mark.parametrize("against", ["sharded", "single"])
@pytest.mark.parametrize("what", ["out", "loss", "grad"])
def test_pna_sharded(results, what, against):
    """PNA_SHARDED: dst-partitioned over all 8 ranks."""
    ref, port = results
    want = matching(ref, f"pna/{against}/{what}")
    got = matching(port, f"pna/{what}")
    assert want and set(got) == set(want)
    for k in want:
        close(got[k], want[k], f"pna {what}{k} vs {against}")


@pytest.mark.parametrize("against", ["sharded", "single"])
@pytest.mark.parametrize("what", ["out", "grad"])
@pytest.mark.parametrize("mask", ["causal", "full"])
def test_cp_attention(results, mask, what, against):
    """CP_ATTENTION: [2, 6, 32, 8] queries over [2, 2, 32, 8] keys."""
    ref, port = results
    want = matching(ref, f"cp/{mask}/{against}/{what}")
    got = matching(port, f"cp/{mask}/{what}")
    assert want and set(got) == set(want)
    for k in want:
        close(got[k], want[k], f"cp {mask} {what}{k} vs {against}")


@pytest.mark.parametrize("against", ["sharded", "single"])
def test_combine_partials(results, against):
    """COMBINE_PARTIALS: split-KV decode over the model axis."""
    ref, port = results
    close(port["dec/sharded"], ref[f"dec/{against}"], "combine_partials")
    close(port["dec/single"], ref["dec/single"], "decode_attention")


@pytest.mark.parametrize("against", ["sharded", "single"])
def test_transformer_cp(results, against):
    """TRANSFORMER_CP: yi-34b's smoke config with cp_mesh."""
    ref, port = results
    close(port["yi/logits"], ref[f"yi/{against}/logits"], "logits")
    close(port["yi/loss"], ref["yi/single/loss"], "loss")


@pytest.mark.parametrize("what", ["loss", "grad"])
def test_mind_logits_pspec(results, what):
    """MIND_LOGITS: row-sharded in-batch logits == one device."""
    ref, port = results
    want = matching(ref, f"mind/single/{what}")
    got = matching(port, f"mind/{what}")
    assert want and set(got) == set(want)
    for k in want:
        close(got[k], want[k], f"mind {what}{k}")


def _psum_oracle(xs):
    """The formula in numpy (float32): one scale for both data shards."""
    scale = np.maximum(np.abs(xs).max() / np.float32(127.0),
                       np.float32(1e-12)).astype(np.float32)
    q = np.clip(np.round(xs / scale), -127, 127).astype(np.int8)
    resid = xs - q.astype(np.float32) * scale
    tot = q[:4].astype(np.int32) + q[4:].astype(np.int32)
    val = tot.astype(np.float32) * scale / np.float32(2.0)
    return q, resid, np.concatenate([val, val])


def test_compressed_psum_exact_against_the_formula(results):
    """COMPRESSED_PSUM: codes, residuals and the mean bit for bit."""
    _, port = results
    xs = make_inputs()["psum_x"]
    q, resid, val = _psum_oracle(xs)
    np.testing.assert_array_equal(port["psum/codes"], q)
    np.testing.assert_array_equal(port["psum/resid"], resid)
    np.testing.assert_array_equal(port["psum/val"], val)


def test_compressed_psum_within_the_reference_bound(results):
    ref, port = results
    xs = make_inputs()["psum_x"]
    exact = (xs[:4] + xs[4:]) / 2.0
    bound = 2.1 * np.abs(xs).max() / 127.0
    assert np.abs(port["psum/val"][:4] - exact).max() <= bound
    close(port["psum/val"], ref["psum/val"], "psum value vs reference",
          dict(rtol=0, atol=np.abs(xs).max() / 127.0 + 1e-7))
    close(port["psum/resid"], ref["psum/resid"], "residual vs reference",
          dict(rtol=0, atol=np.abs(xs).max() / 127.0 + 1e-7))


@pytest.mark.parametrize("what", ["params", "ef", "moments"])
def test_compressed_dp_step_bit_for_bit(results, what):
    """COMPRESSED_DP_STEP: 3 steps of the 2-rank group step == the
    one-process step over 2 shards."""
    _, port = results
    assert bool(port[f"dp/{what}_equal"])
    assert int(port["dp/ef_nonzero"]) > 0
    close(port["dp/loss"], port["dp/twin_loss"], "losses",
          dict(rtol=1e-6, atol=1e-6))


def test_remesh_blocks_reassemble(results):
    _, port = results
    assert bool(port["remesh/equal"])
    assert int(port["remesh/sharded_leaves"]) > 0


def test_collectives_were_counted(results):
    _, port = results
    counts = str(port["counts"])
    for name in ("all_gather", "all_to_all", "psum", "pmax",
                 "reduce_scatter"):
        assert f"'{name}'" in counts, name


# ------------------------------------------------------- the spawn helper

def failing_rank(rank, world_size, init_method):
    from repro_torch.launch.mesh import make_rank_mesh
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    make_rank_mesh(world_size, rank, init_method, (world_size,), ("data",),
                   backend="gloo", devices="cpu", timeout_s=60)


def sleeping_rank(rank, world_size, init_method):
    import time
    time.sleep(60)


def test_spawn_raises_the_failing_rank_and_kills_the_rest():
    import multiprocessing as mp

    from repro_torch.launch.spawn import spawn
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        spawn(failing_rank, 2, timeout=60.0)
    assert not mp.active_children()


def test_spawn_kills_ranks_past_the_deadline():
    import multiprocessing as mp
    import time

    from repro_torch.launch.spawn import spawn
    t0 = time.time()
    with pytest.raises(TimeoutError):
        spawn(sleeping_rank, 2, timeout=3.0)
    assert time.time() - t0 < 30
    assert not mp.active_children()

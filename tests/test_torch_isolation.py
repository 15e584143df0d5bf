"""The port stands alone: no JAX and nothing of the reference package.

Every module of ``repro_torch`` and ``chip_smoke.py`` must import in a
process where ``jax`` and ``repro`` cannot be imported at all, and an AST
scan shows that no file of the port names either.  ``chip_smoke.py`` must
fail, printing no result line, on a host without a CUDA device and in a
directory that holds nothing else of the repository.
"""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "repro")


def port_modules():
    return sorted(["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PORT)], "repro_torch.")])


def port_files():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


def test_port_has_the_slice_modules():
    mods = set(port_modules())
    for name in ("utils.misc", "core.schema", "core.pattern", "core.parser",
                 "core.matcher", "core.optimizer", "graphops.csr",
                 "core.graph", "kernels.ops", "kernels.ref", "kernels.build",
                 "core.executor", "core.plan", "core.maintenance",
                 "core.views", "data.synthetic", "configs.mv4pg", "interop",
                 "core.selection", "core.online_selection", "serve.engine",
                 "graphops.sampler", "graphops.view_subgraph",
                 "models.common", "models.gnn.graphdata", "models.gnn.sage",
                 "launch.gnn", "mv4pg", "graphops.distributed",
                 "launch.mesh", "graphops.segment", "models.gnn.pna",
                 "configs.base", "configs.pna", "models.attention",
                 "models.moe", "models.transformer", "configs.starcoder2_3b",
                 "configs.gemma_2b", "configs.yi_34b",
                 "configs.qwen2_moe_a2_7b", "configs.qwen3_moe_235b_a22b",
                 "configs.shapes", "data.tokens", "serve.llm",
                 "launch.serve", "train.optimizer", "train.compression",
                 "train.trainer", "train.checkpoint", "train.fault",
                 "launch.train", "models.gnn.radial", "models.gnn.irreps",
                 "models.gnn.dimenet", "models.gnn.nequip",
                 "models.gnn.mace", "models.recsys.embedding",
                 "models.recsys.mind", "configs.dimenet", "configs.nequip",
                 "configs.mace", "configs.mind", "utils.jax_random",
                 "launch.collectives", "launch.sharding", "launch.spawn",
                 "models.moe_sharded", "models.transformer_sharded",
                 "launch.steps", "launch.dryrun", "roofline",
                 "roofline.analysis", "roofline.report_md"):
        assert f"repro_torch.{name}" in mods, name
    for src in ("block_spmm", "segment_agg", "flash_attention"):
        assert (PORT / "kernels" / "csrc" / f"{src}.cu").is_file(), src
    from repro_torch.kernels import build, ops
    assert build.sources() == ["block_spmm", "flash_attention",
                               "segment_agg"]
    for name in ("block_spmm", "segment_multi_agg", "flash_attention"):
        assert getattr(ops, name).launches >= 0, name
    assert callable(ops.bucketize_messages)


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"


GRAPH_OWNERS = ("g", "graph")


def _graph_field(node) -> bool:
    """Is ``node`` a field of a graph: ``g.<f>``, ``self.g.<f>``,
    ``sess.g.<f>`` (any ``<x>.g.<f>``) or ``graph.<f>``?"""
    if not isinstance(node, ast.Attribute):
        return False
    owner = node.value
    if isinstance(owner, ast.Name):
        return owner.id in GRAPH_OWNERS
    return isinstance(owner, ast.Attribute) and owner.attr in GRAPH_OWNERS


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_numpy_pull_of_a_graph_field(path):
    """A graph's fields are device tensors: ``np.asarray``/``np.array`` of
    one works on the CPU and raises on the card, so every such read goes
    through ``repro_torch.utils.host``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("asarray", "array")
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in ("np", "numpy")
                and node.args):
            arg = node.args[0]
            inner = arg.func if isinstance(arg, ast.Call) else arg
            targets = [arg, inner] + ([inner.value] if isinstance(
                inner, ast.Attribute) else [])
            assert not any(_graph_field(t) for t in targets), \
                f"{path.relative_to(ROOT)}:{node.lineno} pulls a graph " \
                f"field with np.{node.func.attr}"


# modules whose device-to-host reads must all go through host()/host_flag()
SYNC_COUNTED = ("core/plan.py",)


def _sync_free_arg(arg) -> bool:
    """May ``int(arg)``/``bool(arg)`` stand in a sync-counted module?  Only
    where ``arg`` cannot be a device tensor: a shape, ``len(...)``, a numpy
    call or a constant."""
    if isinstance(arg, ast.Constant):
        return True
    if any(isinstance(n, ast.Attribute) and n.attr == "shape"
           for n in ast.walk(arg)):
        return True
    if isinstance(arg, ast.Call):
        f = arg.func
        if isinstance(f, ast.Name) and f.id == "len":
            return True
        while isinstance(f, ast.Attribute):
            f = f.value
        return isinstance(f, ast.Name) and f.id in ("np", "numpy")
    return False


@pytest.mark.parametrize("rel", SYNC_COUNTED)
def test_no_bare_device_read_in_the_plans(rel):
    """Compiled plans read device state only through ``host()`` (the batch
    pull) and ``host_flag()`` (the closure's flag), both counted: no
    ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()``, and no
    ``bool(t)``/``int(t)``/``float(t)`` of anything that may be a tensor."""
    path = PORT / rel
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        where = f"{path.relative_to(ROOT)}:{node.lineno}"
        if isinstance(f, ast.Attribute):
            assert f.attr not in ("item", "tolist", "cpu", "numpy"), \
                f"{where} reads the device with .{f.attr}()"
        if isinstance(f, ast.Name) and f.id in ("bool", "int", "float"):
            assert node.args and _sync_free_arg(node.args[0]), \
                f"{where} calls {f.id}() on what may be a tensor"


def test_sync_rule_catches_bare_reads():
    """The rule above refuses the reads it is meant to refuse."""
    for bad in ("bool(frontier.any())", "int(x.sum())", "t.item()",
                "bool(flag)", "float(ms)"):
        call = ast.parse(bad).body[0].value
        f = call.func
        refused = ((isinstance(f, ast.Attribute) and f.attr == "item")
                   or not _sync_free_arg(call.args[0]))
        assert refused, bad
    for ok in ("int(a.shape[0])", "int(np.sum(v))", "bool(len(x))",
               "int(3)"):
        assert _sync_free_arg(ast.parse(ok).body[0].value.args[0]), ok


_BLOCKED = """
import importlib, importlib.util, sys
for name in {forbidden!r}:
    sys.modules[name] = None          # any import of these raises
for name in {modules!r}:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r}
                and sys.modules[m] is not None)
assert not loaded, loaded
print("IMPORTED", len({modules!r}))
"""


def test_every_module_imports_without_jax():
    mods = port_modules()
    code = _BLOCKED.format(forbidden=FORBIDDEN, modules=mods,
                           smoke=str(SMOKE))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"IMPORTED {len(mods)}" in out.stdout


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def _assert_no_result(out):
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _assert_no_result(_run_smoke(ROOT))


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    _assert_no_result(_run_smoke(tmp_path))


def test_chip_smoke_phases_rehearse_on_cpu():
    """The smoke's session phases, at a tiny scale on the host: every check
    they make (views on == off, kernel session == segment session, views
    consistent after CE/DE/DV) runs here with the plain kernel version."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    snb = smoke.snb_phase(0.02, device="cpu")
    assert snb["nodes"] > 0
    fin = smoke.finbench_phase(0.02, device="cpu")
    assert fin["max_memory_allocated"] is None
    assert fin["checks"]["reads_compared"]["after_writes"] == 7
    for rec in (snb["checks"], fin["checks"]):
        compared = rec["reads_compared"]
        assert compared["without_views"] == compared["with_views"] == 7
        assert len(rec["views_checked"]) == 3
        assert set(rec["writes"]) == {"CE", "DE", "DV"}


def test_chip_smoke_sharded_phase_rehearses_on_cpu():
    """Phase 9 at a tiny scale on the host, 4 shards on the CPU: every read
    of the sharded session equal to the unsharded one's without and with
    views, the views consistent and equal after CE/DE/DV, sweeps routed to
    the views' owner shards, and a cut of the serve script with every
    ticket and the shared groups equal."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rec = smoke.sharded_phase(0.02, "cpu", clients=2, rounds=1)
    assert rec["shard_devices"] == ["cpu"] * smoke.SHARDS
    assert rec["n_loc"] * smoke.SHARDS >= rec["node_cap"]
    assert len(rec["reads"]) == 14
    assert rec["sweeps_by_owner"]
    assert set(rec["sweeps_by_owner"]) <= set(rec["view_owners"].values())
    assert rec["shared_groups"] > 0 and rec["serve_queries"] == 7 * 3


def test_chip_smoke_serve_phase_rehearses_on_cpu():
    """Phase 7 at a tiny scale on the host: every serve ticket equal to the
    sequential twin's answer on SNB and on FinBench with the served
    session's dense hops on ``block_spmm`` (its plain version here, so no
    launch is counted), and online selection funding views from measured
    builds while its reads agree with a views-off engine."""
    import importlib.util

    from repro_torch.kernels import ops
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    snb = smoke.serve_snb(0.02, "cpu", clients=2, rounds=1)
    assert snb["queries"] == 7 * 3 and snb["share_rate"] > 0
    assert snb["gathers"] > 0 and snb["fences"] == 1
    fin = smoke.serve_finbench(ops, 0.02, "cpu", clients=2, rounds=1)
    assert fin["queries"] == 7 * 3 and fin["share_rate"] == 0.0
    assert fin["launches"] == 0 and fin["block_sizes"]
    online = smoke.online_phase(0.02, "cpu", rounds=4)
    assert online["creates"] >= 1
    assert online["reused_builds"] == online["creates"]


def test_chip_smoke_kernel_phases_rehearse_on_cpu():
    """Phases 5-6 run at their card sizes only; their helpers run here: the
    scatter oracle against bucketize + segment_multi_agg on a tiny SNB
    graph, the SDPA yardstick (lower-right diagonal, grouped KV) against
    the plain attention at a decode shape within the bf16 tolerance, that
    tolerance refusing a diagonal shifted by one key, phase 2's operands
    above 255 through the plain version, the ``block_spmm`` bound (bytes,
    0.90 ms at the workload shape) and the attention bound counting the
    visible pairs."""
    import importlib.util

    from repro_torch.data.synthetic import snb_like
    from repro_torch.kernels import ops, ref
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    g, _, _ = snb_like(seed=0, n_person=40, n_post=30, n_comment=240,
                       device="cpu")
    N = g.num_nodes()
    dst = g.edge_dst[g.edge_alive].to(torch.int64)
    gen = torch.Generator().manual_seed(0)
    msg = torch.randn((dst.shape[0], smoke.PNA_D_HIDDEN), generator=gen)
    mean, mx, mn, _ = ops.segment_multi_agg(
        *ops.bucketize_messages(dst, msg, N))
    want_mean, want_max, want_min = smoke.scatter_aggregates(dst, msg, N)
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=1e-6)
    assert torch.equal(mx, want_max) and torch.equal(mn, want_min)

    B, Hq, Hkv, Sq, Sk, D = 1, 4, 1, 128, 4096, 128
    q, k, v = (torch.randn(s, generator=gen).to(torch.bfloat16)
               for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))
    rtol, atol = smoke.ATTN_TOL[torch.bfloat16]
    want = ref.flash_attention_ref(q, k, v).to(torch.float32)
    lib = smoke.sdpa(*(x.to(torch.float64) for x in (q, k, v)), True)
    assert torch.allclose(lib.to(torch.bfloat16).to(torch.float32), want,
                          rtol=rtol, atol=atol)
    shifted = ref.flash_attention_ref(q, k[:, :, :-1], v[:, :, :-1])
    assert not torch.allclose(shifted.to(torch.float32), want, rtol=rtol,
                              atol=atol)

    for name, (F, A, _) in smoke.wide_cases("cpu").items():
        assert int(max(F.max(), A.max())) > 255, name
        assert torch.equal(ops.block_spmm(F, A, out_dtype=torch.int32),
                           ref.block_spmm_ref(F, A).to(torch.int32)), name
    bound_ms, bound_by = smoke.spmm_bound_ms(*smoke.WORKLOAD_SHAPE)
    assert bound_by == "bytes" and 0.89 < bound_ms < 0.91

    q, k = torch.zeros((1, 1, 4, 8)), torch.zeros((1, 1, 6, 8))
    pairs = int(ref._causal_mask(4, 6, "cpu").sum())
    bound_ms, bound_by = smoke.attn_bound_ms(q, k, True)
    assert pairs == 18 and bound_by == "bytes"
    assert bound_ms == max(4.0 * 8 * pairs / smoke.PEAK_FP32_FLOPS,
                           (2 * 32 + 2 * 48) * 4 / smoke.PEAK_BYTES) * 1e3


def test_chip_smoke_segment_phase_rehearses_on_cpu():
    """Phase 5's helpers on the host, at a tiny scale: the unit inputs
    (rows all valid and empty), the kernel-vs-plain check at every unit
    shape, the NaN cases, the scatter oracle at both dtypes on a tiny SNB
    graph, and the bytes that set the bound at both SNB shapes (the counts
    of the full-size graphs: N, W and valid slots)."""
    import importlib.util

    from repro_torch.kernels import ops, ref
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gen = torch.Generator().manual_seed(0)
    for shape in smoke.AGG_UNIT_SHAPES:
        for dtype in smoke.AGG_TOL:
            msg, valid = smoke.agg_inputs(shape, dtype, gen, "cpu")
            assert msg.dtype == dtype and bool(valid[0].all())
            assert not bool(valid[1:3].any())
            smoke.agg_check(ops, ref, msg, valid, f"{shape} {dtype}")
    for dtype in smoke.AGG_TOL:
        for D in (75, 96):
            assert smoke.agg_nan_check(ops, ref, dtype, D, gen, "cpu") == 0.0

    dst, msg_e, N = smoke.snb_messages(gen, "cpu", n_person=40, n_post=30,
                                       n_comment=240, n_place=6, n_tag=30)
    bucketed, valid = ops.bucketize_messages(dst, msg_e, N)
    for dtype in smoke.AGG_TOL:
        outs = ops.segment_multi_agg(bucketed.to(dtype), valid)
        smoke.scatter_check(outs, dst, msg_e.to(dtype), N, str(dtype))
    with pytest.raises(AssertionError):
        outs = list(ops.segment_multi_agg(bucketed, valid))
        outs[1] = outs[1].nextafter(torch.tensor(torch.inf))
        smoke.scatter_check(outs, dst, msg_e, N, "max one step up")
    for (n, w, e), need in (((15860, 45, 44698), 33155100),
                            ((158600, 53, 445845), 332479300)):
        v = torch.empty((n, w), dtype=torch.bool)
        assert smoke.agg_bytes(v, e, smoke.PNA_D_HIDDEN, 4) == need
    assert smoke.SNB_X10["n_comment"] == 10 * 12000


def test_chip_smoke_gnn_phase_rehearses_on_cpu():
    """Phase 8 at a tiny scale on the host: SAGE trains on KNOWS2 with
    finite losses, one knows write rebuilds the maintained CSR once and its
    batch equals the views-off twin's re-extraction, ``embed_on_view``
    through ``block_spmm`` (its plain version here, so no launch is
    counted) equals the segment path over KNOWS2 and ROOT_POST, the served
    embedder answers behind a knows fence, and the kernel check at
    ROOT_POST's shape holds; the fp32 bound at a 13,568-node ROOT_POST is
    set by operations."""
    import importlib.util

    from repro_torch import mv4pg as pg
    from repro_torch.kernels import ops, ref
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rec = smoke.gnn_phase(ops, ref, 0.05, "cpu", pg.TrainConfig(epochs=2))
    assert rec["epochs"] == 2 and rec["steps"] > 0
    assert rec["knows2_edges"] > 0 and rec["root_post_nodes"] > 0
    assert rec["launches"] == 0 and rec["launches_by_route"] == {
        "tc": 0, "fp32": 0}
    kernel = rec["kernel"]
    n = kernel["shape"][0]
    assert n % 128 == 0 and kernel["shape"] == [n, n, 128]
    assert kernel["max_abs_err"] == 0.0 and "ms" not in kernel
    bound_ms, bound_by = smoke.spmm_fp32_bound_ms(13568, 13568, 128)
    assert bound_by == "operations"
    assert bound_ms == 2.0 * 13568 ** 2 * 128 / smoke.PEAK_FP32_FLOPS * 1e3
    with pytest.raises(AssertionError):
        smoke.within(np.ones(3), np.ones(3) + 1e-3, 1e-4, 1e-6, "off")


def test_chip_smoke_side_stacks_rehearse_on_cpu():
    """Phase 10 at a tiny scale on the host (the card's side of each
    comparison is the CPU here): PNA's smoke config on a 48-node padded
    graph (forward, loss and gradient compared, no timing), PNA's aggregate
    against ``bucketize_messages`` + ``segment_multi_agg`` (its plain
    version) and the scatter oracle on a tiny SNB graph, the LLM engine
    serving the starcoder2-3b smoke config through 2 slots (every request
    at its length, the repeated prompt's output equal, the byte bound from
    the weights and the cache), and the parity phase on the smoke configs
    of starcoder2-3b and qwen2-moe-a2.7b (no parting between the 4-slot
    engine and 1-slot runs)."""
    import importlib.util

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    pna = smoke.pna_phase(get_arch("pna").smoke(), 48, 160, "cpu")
    assert pna["nodes"] == [48, 128] and pna["edges"] == [160, 256]
    assert pna["max_abs_err"] == 0.0 and pna["grad_max_abs_err"] == 0.0
    assert np.isfinite(pna["loss"]) and "forward_ms" not in pna

    gen = torch.Generator().manual_seed(0)
    dst, msg, N = smoke.snb_messages(gen, "cpu", n_person=40, n_post=30,
                                     n_comment=240, n_place=6, n_tag=30)
    agg = smoke.pna_aggregate_check(ops, dst, msg, N, "tiny SNB")
    assert agg["edges"] == dst.shape[0] and "pna_path_ms" not in agg
    assert agg["max_abs_err_vs_kernel"] <= smoke.AGG_TOL[torch.float32]

    cfg = get_arch("starcoder2-3b").smoke()
    llm = smoke.llm_serve_phase(cfg, slots=2, requests=5,
                                prompt_lens=(4, 12), max_new=6, max_len=32,
                                device="cpu")
    assert llm["params"] == cfg.param_count() and llm["tokens"] == 30
    assert len(llm["prefill_ms_by_len"]) == 5 and llm["decode_steps"] >= 15
    assert llm["cache_bytes"] == 2 * 4 * cfg.n_layers * 2 * \
        cfg.n_kv_heads * 32 * cfg.head_dim
    assert llm["decode_bound_ms"] == (llm["param_bytes"] + llm[
        "cache_bytes"]) / smoke.PEAK_BYTES * 1e3
    assert "max_memory_allocated" not in llm

    par = smoke.llm_parity_phase(
        "cpu", starcoder=cfg, qwen=get_arch("qwen2-moe-a2.7b").smoke())
    assert set(par) == {"starcoder2-3b", "qwen2-moe-a2.7b"}
    assert par["starcoder2-3b"]["engine"] == {
        "requests": 6, "slots": smoke.LLM_SLOTS, "partings": []}
    assert all(r["max_abs_err"] == 0.0 for r in par.values())


# the modules phase 11 drives, and every port module they import
TRAIN_PATH = ("repro_torch.launch.train", "repro_torch.train.trainer",
              "repro_torch.train.fault", "repro_torch.models.gnn.dimenet",
              "repro_torch.models.gnn.nequip", "repro_torch.models.gnn.mace",
              "repro_torch.models.recsys.mind")


def _port_imports(module: str) -> set:
    """The port modules ``module`` imports, transitively (by AST)."""
    seen, todo = set(), [module]
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        rel = mod.split(".")[1:]
        path = PORT.joinpath(*rel).with_suffix(".py")
        if not path.is_file():
            path = PORT.joinpath(*rel, "__init__.py")
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] + [f"{node.module}.{a.name}"
                                         for a in node.names]
            for name in names:
                if name.startswith("repro_torch.") and (
                        PORT.joinpath(*name.split(".")[1:]).with_suffix(
                            ".py").is_file()
                        or PORT.joinpath(*name.split(".")[1:]).is_dir()):
                    todo.append(name)
    return seen


def test_chip_smoke_train_phases_rehearse_on_cpu():
    """Phase 11 at smoke sizes on the host: starcoder2-3b's smoke config
    trained 2 steps of two microbatches and its 2-layer parity step (card
    side on the CPU: every error 0), the training CLI's loop recovering
    from a failure injected at step 5 of 8 (checkpoints every 2) and the
    8-bit checkpoint round trip, DimeNet, NequIP and MACE at their smoke
    configs on 4 molecules, MIND's smoke config at a batch of 64.  No
    kernel wrapper counts a launch, and no module of phase 11's path
    imports the kernels at all."""
    import importlib.util

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name in TRAIN_PATH:
        assert not any(m.startswith("repro_torch.kernels")
                       for m in _port_imports(name)), name
    smoke.reset_launches(ops)

    lm = get_arch("starcoder2-3b").smoke()
    rec = smoke.train_lm_phase(lm, steps=2, seq=32, accum=2, device="cpu")
    assert rec["params"] == lm.param_count() and len(rec["losses"]) == 2
    assert rec["tokens_per_step"] == 64 and "max_memory_allocated" not in rec
    assert rec["model_flops_per_step"] == 6.0 * lm.param_count() * 64
    par = smoke.train_parity_phase(lm, batch=2, seq=32, device="cpu")
    assert par["max_abs_err"] == par["grad_max_abs_err"] == \
        par["param_max_abs_err"] == 0.0
    cli = smoke.train_cli_phase(
        "cpu", ("--preset", "smoke", "--arch", "starcoder2-3b"), steps=8,
        fail=5, every=2)
    assert cli["restarts"] == 1 and cli["resumed_from"] in (2, 4)
    assert cli["steps_done"] == 8 + 5 - cli["resumed_from"]
    assert cli["eight_bit_leaves"] > 3 * len(lm.__dataclass_fields__) - 40

    mol = smoke.molecular_phase(
        {a: get_arch(a).smoke() for a in ("dimenet", "nequip", "mace")},
        shape=(6, 14, 4), pad=32, steps=2, device="cpu")
    assert set(mol) == {"dimenet", "nequip", "mace"}
    for arch, r in mol.items():
        assert r["max_abs_err"] == r["grad_max_abs_err"] == 0.0, arch
        assert r["nodes"] == 32 and r["edges"] == 64 and r["graphs"] == 4
        assert len(r["train_losses"]) == 2
    assert mol["nequip"]["forces_err"] == 0.0
    assert mol["dimenet"]["triplets"][1] == 512

    mind = smoke.mind_phase(get_arch("mind").smoke(), batch=64, steps=2,
                            serve=(8, 5), parity_batch=16, device="cpu")
    assert mind["max_abs_err"] == mind["grad_max_abs_err"] == 0.0
    assert mind["serve_max_abs_err"] == mind["retrieval_max_abs_err"] == 0.0
    assert mind["logits_bytes"] == 4 * 64 * 64
    assert not any(getattr(ops, fn).launches for fn in
                   ("block_spmm", "segment_multi_agg", "flash_attention"))


def test_chip_smoke_multidevice_phase_rehearses_on_cpu():
    """Phase 12 at smoke sizes on 4 CPU ranks (gloo): the expert-parallel
    MoE equal to ``moe_apply`` without drops, PNA dst-partitioned, context
    -parallel attention and the split-KV combine, the compressed step bit
    for bit against the one-process step over 4 shards, MIND's row-sharded
    logits; every rank on its device, no kernel launched, and no rank left
    running."""
    import importlib.util
    import multiprocessing as mp
    import time

    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    t0 = time.time()
    rec = smoke.multidevice_phase("cpu", full=False)
    assert time.time() - t0 < 60
    assert not mp.active_children()
    assert rec["backend"] == "gloo" and rec["devices"] == ["cpu"] * 4
    moe = rec["12a_moe"]
    assert moe["routing_partings"] == 0
    assert set(moe["no_drop_rel_err"]) >= {"out", "grad router.w",
                                           "grad wi", "grad x"}
    assert moe["forward_collectives"]["all_to_all"]["calls"] == 2
    assert moe["forward_backward_collectives"]["reduce_scatter"]["calls"] > 0
    assert rec["12b_pna"]["max_abs_err"] < 1e-4
    assert rec["12c_attention"]["rel_err"]["out"] < smoke.BF16_REL
    dp = rec["12d_dp_step"]
    assert dp["params_bitwise"] and dp["ef_bitwise"] and dp["moments_bitwise"]
    assert rec["12e_mind"]["max_abs_err"] < 1e-5
    assert set(rec["seconds"]) == {"12a_moe", "12b_pna", "12c_attention",
                                   "12d_dp_step", "12e_mind"}


def test_chip_smoke_cells_phase_rehearses_on_cpu():
    """Phase 13 at smoke sizes on 4 CPU ranks (gloo): the train cell's
    fp32 step and the decode cell's step equal their single-process twins
    on every rank, the bf16 step's loss finite, the dry run's bound
    counted for the same cell; no kernel launched and no rank left
    running."""
    import importlib.util
    import multiprocessing as mp
    import time

    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    t0 = time.time()
    rec = smoke.cells_phase("cpu", full=False)
    assert time.time() - t0 < 60
    assert not mp.active_children()
    assert rec["backend"] == "gloo" and rec["devices"] == ["cpu"] * 4
    a, b = rec["13a_train"], rec["13b_decode"]
    assert a["act_pspec"] == ["data", "model", None] and a["seq_sharded"]
    assert len(a["parity_by_rank"]) == 4
    for par in a["parity_by_rank"]:
        assert par["routing_partings"] == 0
        assert set(par["scaled"]) >= {"params", "m", "v", "loss", "gnorm"}
        assert max(par["scaled"].values()) <= smoke.CELL_TOL
    assert a["fp32_collectives"]["all_to_all"]["calls"] > 0
    assert a["fp32_collectives"]["reduce_scatter"]["calls"] > 0
    assert a["bf16_loss"] == a["bf16_loss"] and a["bf16_step_ms"]
    bound = a["dryrun_bound"]
    assert bound["bound_ms"] > 0 and bound["dominant"] in (
        "compute", "memory", "collective")
    assert b["dispatch_pspec"][0] == "model"
    for par in b["parity_by_rank"]:
        assert max(par["scaled"].values()) <= smoke.CELL_TOL
    assert set(rec["seconds"]) == {"13a_train", "13b_decode"}

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases:
  1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (nvcc
     into ``build/kernels``) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card, at
     unit shapes and at the FinBench workload shape, and time kernel, plain
     version and a ``torch.matmul`` fp32 yardstick;
  3. the SNB main path: ``snb_like(seed=0)`` through ``GraphSession`` —
     reads without views, three fused view builds, reads with views (equal
     rows), CE/DE/DV writes with recover, ``check_consistency``;
  4. FinBench through the kernel: a session with dense hops on
     ``block_spmm`` against a segment-hop session, reads bit-exact in reach
     rows and DBHit/Rows, writes keeping every view consistent.

Kernel launch counts are zeroed just before phase 3 and read just after
phase 4 (comparison launches of phase 2 do not count).  Every failed check
raises, so the script exits non-zero and prints no result line.  It needs
one CUDA device; without one it exits with code 2.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# card peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

UNIT_SHAPES = [(8, 16, 12), (128, 128, 128), (100, 200, 150), (256, 384, 128)]
WORKLOAD_SHAPE = (256, 27264, 27264)   # src_block x node_cap x node_cap


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` runs (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


# ---------------------------------------------------------------------------
# phase 2: block_spmm against its plain version
# ---------------------------------------------------------------------------

def spmm_checks(ops, ref) -> dict:
    """Exact kernel == plain comparisons (integer-valued inputs) plus the
    workload-shape timings.  Returns the kernel's JSON record fields."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    max_err = 0.0
    for (S, K, N) in UNIT_SHAPES:
        for counting in (True, False):
            for f_dtype in (torch.float32, torch.int32, torch.bool):
                for masked in (False, True):
                    F = torch.from_numpy(rng.integers(0, 3, (S, K))).to(dev)
                    F = F.to(f_dtype)
                    A = torch.from_numpy(
                        (rng.random((K, N)) < 0.2).astype(np.int32)).to(dev)
                    m = (torch.from_numpy(rng.integers(0, 2, N)).to(dev)
                         if masked else None)
                    got = ops.block_spmm(F, A, m, counting=counting)
                    want = ref.block_spmm_ref(
                        F, A, m, semiring="count" if counting else "bool")
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max()) if got.numel() else 0.0
                    max_err = max(max_err, err)
                    check(torch.equal(got, want),
                          f"block_spmm != plain at {(S, K, N)} "
                          f"counting={counting} F={f_dtype} mask={masked}")
    log(f"phase 2: unit shapes exact ({len(UNIT_SHAPES) * 12} cases)")

    S, K, N = WORKLOAD_SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    A = (torch.rand((K, N), generator=gen, device=dev) < 0.2).to(torch.int32)
    F = torch.randint(0, 3, (S, K), generator=gen, device=dev,
                      dtype=torch.int32)
    mask = (torch.rand(N, generator=gen, device=dev) < 0.5).to(torch.float32)
    Ff, Af = F.to(torch.float32), A.to(torch.float32)
    timings = {}
    for counting in (True, False):
        for m in (None, mask):
            semiring = "count" if counting else "bool"
            out_dtype = torch.int32 if counting else torch.uint8
            got = ops.block_spmm(F, A, m, counting=counting,
                                 out_dtype=out_dtype)
            want = ref.block_spmm_ref(F, A, m, semiring=semiring)
            torch.cuda.synchronize()
            err = float((got.to(torch.float32) - want).abs().max())
            max_err = max(max_err, err)
            check(err == 0.0, f"block_spmm != plain at the workload shape "
                              f"({semiring}, mask={m is not None}): {err}")
            key = f"{semiring}{'+mask' if m is not None else ''}"
            timings[key] = {
                "ms": cuda_ms(lambda: ops.block_spmm(
                    F, A, m, counting=counting, out_dtype=out_dtype), 5),
                "plain_ms": cuda_ms(lambda: ref.block_spmm_ref(
                    F, A, m, semiring=semiring), 5),
            }
    library_ms = cuda_ms(lambda: torch.matmul(Ff, Af), 5)
    log(f"phase 2: workload shape {WORKLOAD_SHAPE} exact in count/bool x "
        f"mask/no mask; ms: " + json.dumps(timings)
        + f"; torch.matmul fp32 {library_ms:.3f} ms")
    flops = 2.0 * S * K * N
    nbytes = F.numel() * 4 + A.numel() * 4 + S * N * 4   # count, no mask
    bound_by = "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES \
        else "bytes"
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    del A, F, Ff, Af
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "ms": timings["count"]["ms"],
            "plain_ms": timings["count"]["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "timings": timings}


# ---------------------------------------------------------------------------
# phases 3-4: the session main path
# ---------------------------------------------------------------------------

def write_targets(sess, rng):
    """A base edge to delete, endpoints for a new edge, and a node (the
    workload driver's CE/DE/DV targets)."""
    from repro_torch.utils import host
    g = sess.g
    alive = np.flatnonzero(host(g.edge_alive))
    view_lids = [v.label_id for v in sess.views.values()]
    labels = host(g.edge_label)[alive]
    base = alive[~np.isin(labels, view_lids)]
    eid = int(rng.choice(base))
    src, dst = int(host(g.edge_src)[eid]), int(host(g.edge_dst)[eid])
    elabel = sess.schema.edge_labels.name_of(int(host(g.edge_label)[eid]))
    nid = int(rng.choice(np.flatnonzero(host(g.node_alive))))
    return eid, (src, dst, elabel), nid


def run_writes(sess, seed: int = 0) -> None:
    """CE, DE and DV with recover, as the paper workload runs them."""
    from repro_torch.core import graph as G
    from repro_torch.utils import host
    eid, (src, dst, elabel), nid = write_targets(sess, np.random.default_rng(seed))
    slot = sess.create_edge(src, dst, elabel)        # CE (maintained)
    sess.delete_edge(slot)                           # recover
    sess.delete_edge(eid)                            # DE
    sess.create_edge(src, dst, elabel)               # recover
    g = sess.g                                       # DV
    e_alive, e_src = host(g.edge_alive), host(g.edge_src)
    e_dst, e_lab = host(g.edge_dst), host(g.edge_label)
    inc = np.flatnonzero(e_alive & ((e_src == nid) | (e_dst == nid)))
    nlabel, nkey = int(host(g.node_label)[nid]), int(host(g.node_key)[nid])
    sess.delete_node(nid)
    sess.g = G.create_node(sess.g, nid, nlabel, nkey)  # recover
    view_lids = {v.label_id for v in sess.views.values()}
    for e in inc:
        if int(e_lab[e]) not in view_lids:
            sess.create_edge(int(e_src[e]), int(e_dst[e]),
                             sess.schema.edge_labels.name_of(int(e_lab[e])))


def check_views(sess, what: str) -> None:
    for name in sess.views:
        check(sess.check_consistency(name), f"{what}: view {name} inconsistent")


def snb_phase(scale: float = 1.0, device: str = "cuda") -> dict:
    from repro_torch.configs.mv4pg import SNB_WORKLOAD as WL
    from repro_torch.core import GraphSession
    from repro_torch.data.synthetic import snb_like
    g, schema, _ = snb_like(seed=0, n_person=int(2000 * scale),
                            n_post=int(1500 * scale),
                            n_comment=int(12000 * scale), device=device)
    sess = GraphSession(g, schema, device=device)
    log(f"phase 3: snb_like nodes={g.num_nodes()} edges={g.num_edges()} "
        f"node_cap={g.node_cap}")
    base = []
    for q in WL.reads:
        res = sess.query(q, use_views=False)
        base.append((res.reach, res.num_results()))
    for v in WL.views:
        sess.create_view(v)
    for i, q in enumerate(WL.reads):
        res = sess.query(q, use_views=True)
        check(np.array_equal(res.reach, base[i][0])
              and res.num_results() == base[i][1],
              f"SNB Q{i + 1}: rows with views differ from rows without")
    base.clear()
    check_views(sess, "SNB after build")
    run_writes(sess)
    check_views(sess, "SNB after CE/DE/DV")
    return {"nodes": g.num_nodes(), "node_cap": g.node_cap}


def finbench_phase(scale: float = 1.0, device: str = "cuda") -> dict:
    from repro_torch.configs.mv4pg import FINBENCH_WORKLOAD as WL
    from repro_torch.core import ExecConfig, GraphSession
    from repro_torch.data.synthetic import finbench_like
    sessions = {}
    for name, cfg in (("K", ExecConfig(backend="dense", use_kernel=True)),
                      ("S", ExecConfig())):
        g, schema, _ = finbench_like(
            seed=0, n_account=int(4000 * scale), n_person=int(1500 * scale),
            n_company=int(500 * scale), n_loan=int(800 * scale),
            device=device)
        sessions[name] = GraphSession(g, schema, cfg, device=device)
    K, S = sessions["K"], sessions["S"]
    log(f"phase 4: finbench_like nodes={K.g.num_nodes()} "
        f"node_cap={K.g.node_cap}")

    def reads(use_views: bool, what: str) -> None:
        for i, q in enumerate(WL.reads):
            rk = K.query(q, use_views=use_views)
            rs = S.query(q, use_views=use_views)
            check(np.array_equal(rk.reach, rs.reach)
                  and rk.metrics == rs.metrics,
                  f"FinBench Q{i + 1} {what}: kernel session differs "
                  f"({rk.metrics} vs {rs.metrics})")

    reads(False, "without views")
    for v in WL.views:
        K.create_view(v)
        S.create_view(v)
    reads(True, "with views")
    for sess in (K, S):
        check_views(sess, "FinBench after build")
        run_writes(sess)
        check_views(sess, "FinBench after CE/DE/DV")
    for name in K.views:
        check(K.views[name].pair_slot == S.views[name].pair_slot,
              f"FinBench view {name}: kernel session stores other pairs")
    reads(True, "after writes")
    return {"max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if device == "cuda" else None)}


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build, ops, ref
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable ({exc}); run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}

    t0 = time.perf_counter()
    build.load("block_spmm")
    seconds["build"] = time.perf_counter() - t0
    log(f"phase 1: built block_spmm in {seconds['build']:.1f} s")
    ptxas = build.build_log["block_spmm"]["ptxas"]
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", ptxas)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", ptxas)]
    if regs:
        log(f"phase 1: ptxas over {len(regs)} instantiations: at most "
            f"{max(regs)} registers, {max(spills)} bytes of spill stores")
    smi = nvidia_smi()
    log(f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    rec = spmm_checks(ops, ref)
    seconds["kernel_checks"] = time.perf_counter() - t0

    ops.block_spmm.launches = 0
    t0 = time.perf_counter()
    snb = snb_phase()
    seconds["snb"] = time.perf_counter() - t0
    snb_launches = ops.block_spmm.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fin = finbench_phase()
    seconds["finbench"] = time.perf_counter() - t0
    launches = ops.block_spmm.launches
    check(launches > 0, "the main path never launched block_spmm")
    log(f"phase 3: SNB {json.dumps(snb)}; "
        f"block_spmm launches {snb_launches}")
    log(f"phase 4: block_spmm launches {launches - snb_launches}; "
        f"max_memory_allocated {fin['max_memory_allocated']} B")
    log("seconds " + json.dumps(seconds))

    kernels = [{
        "name": "block_spmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_spmm.cu",
        "replaces": "src/repro/kernels/block_spmm.py:46",
        "launches": launches, "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"], "checked": True,
    }]
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time ``block_spmm``'s u8 route over FinBench's cached adjacencies, with
each adjacency's slab map and with a map that lists every slab (the dense
walk), on the first CUDA device.

    python3 tools/spmm_slab_ab.py [--scale 3] [--iters 50]

Builds ``finbench_like`` at ``scale`` times its default node counts with
slack 1.5 (scale 3: 20,400 nodes, node_cap 30,720, as the benchmark's
``finbench_x3_dense``), takes each edge label's dense count adjacency in
both directions from a session's engine, and times, at S = 256 frontier
rows (one-hot rows of the label's first 256 sources, int32): the map's
build, the hop walking its map, and the hop walking every slab.  Both hops
are held to the plain version bit for bit.  Prints one JSON line per
adjacency, then the card's name and power limit.  Times are CUDA events
over ``iters`` launches in a row, after a warm-up launch.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def events_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=3)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    import repro_torch.core as P
    from repro_torch.data.synthetic import finbench_like
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    k = args.scale
    g, schema, _ = finbench_like(0, n_account=4000 * k, n_person=1500 * k,
                                 n_company=500 * k, n_loan=800 * k,
                                 slack=1.5, device=dev)
    sess = P.GraphSession(g, schema, P.ExecConfig(backend="dense",
                                                  use_kernel=True),
                          device=dev)
    eng = sess.engine
    S = 256
    for lid in range(len(schema.edge_labels)):
        name = schema.edge_labels.name_of(lid)
        for rev in (False, True):
            eng._adj_cache.clear()      # one 3.77 GB adjacency at a time
            A = eng.adj(lid, True, rev)
            smap = ops.spmm_slab_map(A)
            K, N = A.shape
            n_cb, n_slabs = smap.slabs.shape
            full = ops.SlabMap(
                torch.arange(n_slabs, dtype=torch.int16,
                             device=dev).repeat(n_cb, 1),
                torch.full((n_cb,), n_slabs, dtype=torch.int32, device=dev),
                smap.shape)
            src = torch.nonzero(A.sum(1)).flatten()[:S]
            F = torch.zeros((S, K), dtype=torch.int32, device=dev)
            F[torch.arange(src.shape[0], device=dev), src] = 1
            want = ref.block_spmm_ref(F, A)
            hops = {}
            for key, m in (("map", smap), ("dense", full)):
                got = ops.block_spmm(F, A, counting=True,
                                     out_dtype=torch.int32, slab_map=m)
                if not torch.equal(got.to(torch.float32), want):
                    raise SystemExit(f"{name} rev={rev} {key}: != plain")
                hops[key] = events_ms(lambda m=m: ops.block_spmm(
                    F, A, counting=True, out_dtype=torch.int32,
                    slab_map=m), args.iters)
            print(json.dumps({
                "label": name, "reverse": rev, "K": K, "N": N, "S": S,
                "live_tiles": smap.read_live(), "tiles": smap.tiles,
                "live_share": smap.read_live() / smap.tiles,
                "longest_list": int(smap.counts.max()),
                "busy_colblocks": int((smap.counts > 0).sum()),
                "map_build_ms": events_ms(lambda: ops.spmm_slab_map(A),
                                          args.iters),
                "hop_map_ms": hops["map"], "hop_dense_ms": hops["dense"]}),
                flush=True)
            del A
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

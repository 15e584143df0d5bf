"""Dry run: build every (arch x shape) cell on the production meshes and
count its per-rank program on ``meta`` tensors, for the H100 roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out dry.json

The reference lowers and compiles each cell for 256 or 512 placeholder
host devices and never runs a step; the port's counterpart is a meta rank
mesh (``launch.mesh.make_meta_mesh``): rank 0's program runs once on
``meta`` tensors, with no card and no process group, and
``roofline.analysis`` counts it.  A row's times are bounds from counts at
the H100's data-sheet peaks, not measurements.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

from repro_torch.configs import all_cells
from repro_torch.launch.mesh import make_meta_mesh, make_production_mesh


def _meta_production_mesh(multi_pod: bool):
    shape = make_production_mesh(multi_pod=multi_pod)
    return make_meta_mesh(tuple(shape.shape.values()), shape.axis_names,
                          rank=0)


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True) -> dict:
    """One cell's row.  The reference also compiles two calibration cells
    of LM archs and extrapolates their costs to the full depth (XLA counts
    a loop body once); the port's count runs every layer, so it needs
    none (``tests/test_torch_dryrun.py`` holds the extrapolation to the
    direct count)."""
    from repro_torch.launch.steps import build_cell, local_inputs
    from repro_torch.roofline.analysis import analyze_cell, count
    mesh = _meta_production_mesh(multi_pod)
    t0 = time.time()
    cell = build_cell(arch_id, shape_name, mesh)
    t_build = time.time() - t0
    counts = count(cell.fn, local_inputs(cell, cell.args, mesh), mesh)
    t_count = time.time() - t0 - t_build
    report = analyze_cell(cell, mesh, arch=arch_id, shape=shape_name,
                          counts=counts)
    row = report.row()
    row.update({
        "kind": cell.kind, "multi_pod": multi_pod, "status": "ok",
        "build_s": round(t_build, 2), "count_s": round(t_count, 2),
        "note": cell.note, "flops_by_dtype": report.flops_by_dtype,
        "hlo_bytes": report.hlo_bytes, "coll_bytes": report.coll_bytes,
        "coll_calls": counts.coll_calls, "ops": counts.ops,
    })
    if verbose:
        print(f"[{arch_id} x {shape_name}] mesh={tuple(mesh.shape.values())}"
              f" kind={cell.kind} count={t_count:.1f}s ops={counts.ops}")
        print(f"  count: flops={row['hlo_flops']:.3e} "
              f"bytes={row['hlo_bytes']:.3e} coll={row['coll_breakdown']} "
              f"peak/rank={row['peak_memory_bytes']:.3e}")
        print(f"  roofline: compute={row['compute_s']:.3e}s "
              f"memory={row['memory_s']:.3e}s "
              f"collective={row['collective_s']:.3e}s "
              f"dominant={row['dominant']} "
              f"frac={row['roofline_fraction']:.3f}")
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    rows = []
    failures = 0
    for arch_id, shape_name in cells:
        for mp in meshes:
            try:
                rows.append(run_cell(arch_id, shape_name, multi_pod=mp))
            except Exception as e:  # a failing cell is a bug in the system
                failures += 1
                traceback.print_exc()
                rows.append({"arch": arch_id, "shape": shape_name,
                             "multi_pod": mp, "status": "FAIL",
                             "error": f"{type(e).__name__}: {e}"})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=str)
        print(f"wrote {len(rows)} rows -> {args.out}")
    print(f"{len(rows) - failures}/{len(rows)} cells OK")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

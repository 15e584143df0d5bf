"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 mvbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``; ``checks`` last: each number compared with its limit,
which also ends standard error).  Exits non-zero, printing no result,
without a CUDA device, with fewer devices than the cell asks for, or when
JAX or the JAX package was loaded.  ``--control`` runs every read in set
semantics (the port's ``force_bool`` path): the check must then fail.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of the program stays inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "build/triton"),
                 ("TORCH_EXTENSIONS_DIR", "build/torch_extensions")):
    os.environ[var] = str(ROOT / sub)
os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from mvbench import harness
    cell = harness.load_cell(args.workload, ROOT)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T0, control=args.control)
    bad = harness.jax_loaded()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

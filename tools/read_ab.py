"""Time every read and write of SNB and FinBench in two checkouts, in turns.

    python3 tools/read_ab.py OTHER_CHECKOUT

Runs this checkout's ``chip_smoke.snb_phase()`` and ``finbench_phase()``
(the workload driver's table: each of the 7 reads without and with views,
one warm-up and 3 timed runs, the median kept; the view builds; CE/DE/DV
with views and as the raw graph mutation without; then one
``torch.profiler`` trace of SNB's Q1, a full read from Comment, and the
cost of a closure's flag read beside one more hop) against the package of
OTHER_CHECKOUT and of this one, in the order other, this, this, other, each
in a fresh process on the first CUDA device.  It prints one JSON line per
run, then each checkout's two runs side by side per read (median seconds),
then the card's name and power limit.  Compare two versions only within one
such run: times on the card spread between calls.  Each checkout builds its
own ``block_spmm`` at first use.
"""
import json
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[1]

RUN = r'''
import importlib.util, json, sys, time, torch
sys.path.insert(0, "src")
spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from repro_torch.kernels import build
build.build("block_spmm")
torch.backends.cuda.matmul.allow_tf32 = False
out = {}
for name, fn in (("snb", smoke.snb_phase), ("finbench", smoke.finbench_phase)):
    t0 = time.perf_counter()
    rec = fn()
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    rec.pop("max_memory_allocated", None)
    out[name] = rec
print(json.dumps(out))
'''


def side_by_side(runs: list) -> dict:
    """Per workload and table, each checkout's runs per read."""
    out = {}
    for wl in ("snb", "finbench"):
        for key in ("read_without_s", "read_with_s"):
            out[f"{wl} {key}"] = {
                name: [r[wl]["times"][key] for r in runs
                       if r["checkout"] == name]
                for name in ("other", "this")}
        out[f"{wl} writes"] = {
            name: [r[wl]["times"]["writes"] for r in runs
                   if r["checkout"] == name] for name in ("other", "this")}
        out[f"{wl} seconds"] = {
            name: [r[wl]["seconds"] for r in runs if r["checkout"] == name]
            for name in ("other", "this")}
    out["snb trace_q1"] = {
        name: [r["snb"].get("trace_q1") for r in runs
               if r["checkout"] == name] for name in ("other", "this")}
    return out


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    code = RUN.replace("SMOKE", repr(str(THIS / "chip_smoke.py")))
    runs = []
    for tree, name in ((other, "other"), (THIS, "this"), (THIS, "this"),
                       (other, "other")):
        out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return 1
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec = {"checkout": name, "path": str(tree), **rec}
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    for key, val in side_by_side(runs).items():
        print(f"{key}: {json.dumps(val)}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

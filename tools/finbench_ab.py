"""Time the FinBench phase of ``chip_smoke.py`` in two checkouts, in turns.

    python3 tools/finbench_ab.py OTHER_CHECKOUT

Runs ``chip_smoke.finbench_phase()`` (a ``block_spmm`` kernel session
against a segment session, reads and writes) in OTHER_CHECKOUT and in this
one, in the order other, this, this, other, each in a fresh process on the
first CUDA device, and prints one JSON line per run with the phase's
seconds and its ``block_spmm`` launches, then the card's name and power
limit.  Compare two versions only within one such run: times on the card
spread between calls.  Each checkout builds its own kernels at first use.
"""
import json
import subprocess
import sys
from pathlib import Path

RUN = r'''
import json, sys, time, torch
sys.path.insert(0, "src")
import chip_smoke
from repro_torch.kernels import build, ops
build.build("block_spmm")
torch.backends.cuda.matmul.allow_tf32 = False
ops.block_spmm.launches = 0
t0 = time.perf_counter()
chip_smoke.finbench_phase()
torch.cuda.synchronize()
print(json.dumps({"finbench_s": time.perf_counter() - t0,
                  "launches": ops.block_spmm.launches}))
'''


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    this = Path(__file__).resolve().parents[1]
    other = Path(sys.argv[1]).resolve()
    for tree, name in ((other, "other"), (this, "this"), (this, "this"),
                       (other, "other")):
        out = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return 1
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": name, "path": str(tree), **rec}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time ``block_spmm``'s fp32 route on one card, and against other checkouts.

    python3 tools/spmm_fp32_ab.py [--checks] [--sweep] [--sass]
                                  [OTHER_CHECKOUT ...]

Builds this checkout's ``src/repro_torch/kernels/csrc/block_spmm.cu``
through the port's builder and prints each fp32 kernel's registers and
spills (``-Xptxas -v``) and its resident blocks an SM; with ``--sass``, the
instruction mix of ``spmm_fp32_kernel<float, float, float>``'s slab loop
(``cuobjdump -sass``, the loop closed by the kernel's one backward
branch).  With ``--checks`` it
first runs ``chip_smoke.py``'s phase 2 (``spmm_checks``: unit shapes, the
fp32 route's split shapes, values above 255, the workload shape).  Then, on
the operands of SAGE's aggregation at ROOT_POST's and KNOWS2's shapes
(phase 8: a dense fp32 adjacency [n, n] with about 12 small integer weights
a row, and relu features [n, 128]), it holds the route to the plain version
within phase 8's tolerance, checks that two launches give the same bits,
and times it per call by CUDA events (``chip_smoke.cuda_ms``, 20 launches
in a row, host included) beside the plain version, ``torch.matmul`` with
TF32 off and the fp32 bound, with the split plan it took; and on the device
alone (``chip_smoke.device_ms``, a profiler trace: the split kernel and the
pass that adds the partials, beside ``torch.matmul``'s kernels), all by
``chip_smoke.spmm_fp32_check``.  With
``--sweep`` it also times the kernel at forced split counts around the
plan's.  For each OTHER_CHECKOUT given, it builds that checkout's
``block_spmm.cu`` (same flags, into ``build/ab/``), holds its fp32 entry to
the plain version and times it per call in the order other, this, this,
other.  Last, the wrapper's host time a call at a small shape.  It prints
one JSON line per shape, then the card's name and power limit.  Compare two
versions only within one such run.
"""
import ctypes
import hashlib
import json
import re
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

SOURCE = Path("src/repro_torch/kernels/csrc/block_spmm.cu")
# ROOT_POST's and KNOWS2's node counts in phase 8 (full SNB)
SHAPES = {"ROOT_POST": 13440, "KNOWS2": 2048}
ROW_NONZEROS = 12
# forced split counts of --sweep, around each shape's plan
SWEEP = {"ROOT_POST": (1, 3, 4, 5, 6, 10), "KNOWS2": (4, 8, 9, 12, 16, 32)}


def fp32_report(ptxas: str) -> str:
    """Registers and spill stores of each fp32 kernel in a ``-Xptxas -v``
    report."""
    out, name = [], None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            name = re.search(r"(spmm_fp32\w*?kernelI\w+?E)", line)
            name = name.group(1) if name else None
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spill} B spilled")
    return "; ".join(out)


def bind_other(src: Path):
    """Compile ``src`` with the port's flags; a ``run(F, A, out)`` that
    launches its fp32 entry on float32 operands (where that entry takes a
    split, with this checkout's planner at that kernel's blocks an SM)."""
    out = ROOT / "build" / "ab" / (
        f"libblock_spmm-{hashlib.sha256(src.read_bytes()).hexdigest()[:12]}"
        f".so")
    if not out.exists():
        print(f"{src.parents[4].name}: "
              + fp32_report(build.compile_source(src, out)), flush=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.block_spmm_fp32_launch
    split = hasattr(lib, "block_spmm_fp32_blocks_per_sm")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   *[ctypes.c_int] * (6 if split else 5),
                   *[ctypes.c_void_p] * (2 if split else 1)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    if split:                    # the other kernel's own blocks an SM
        occ = lib.block_spmm_fp32_blocks_per_sm
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        if occ(2, 2, 2, ctypes.byref(blocks)) != 0 or blocks.value < 1:
            raise RuntimeError(f"{src}: occupancy query failed")

    def run(F, A, out):
        S, K = F.shape
        N = A.shape[1]
        args = [F.data_ptr(), 2, A.data_ptr(), 2, None, out.data_ptr(), 2,
                S, K, N, 0]
        ws = None
        if split:
            plan = ops.spmm_fp32_plan(
                S, K, N, torch.cuda.get_device_properties(
                    F.device).multi_processor_count, blocks.value)
            ws = (torch.empty(plan.workspace, dtype=torch.float32,
                              device=F.device) if plan.n_split > 1 else None)
            args += [plan.n_split, ws.data_ptr() if ws is not None else None]
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"other block_spmm_fp32_launch: CUDA error "
                               f"{rc}")
        return out
    return run


def operands(n: int, gen):
    """An adjacency-like dense F [n, n] (weights 1..3 at about
    ROW_NONZEROS a row) and relu features h [n, 128]."""
    dev = torch.device("cuda")
    adj = torch.zeros((n, n), device=dev)
    rows = torch.arange(n, device=dev).repeat_interleave(ROW_NONZEROS)
    cols = torch.randint(0, n, (n * ROW_NONZEROS,), generator=gen,
                         device=dev)
    w = torch.randint(1, 4, (n * ROW_NONZEROS,), generator=gen,
                      device=dev).to(torch.float32)
    adj.index_put_((rows, cols), w, accumulate=True)
    h = torch.relu(torch.randn((n, 128), generator=gen, device=dev))
    return adj, h


def loop_mix(lib: Path) -> dict:
    """Opcode counts of the slab loop of the fp32 kernel on float32
    operands and output, from the library's SASS."""
    import collections
    import subprocess
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    fn = next(p for p in re.split(r"\n\s*Function : ", sass)
              if "spmm_fp32_kernelIfffE" in p.split("\n", 1)[0])
    ins = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", fn)]
    back = [(a, int(t, 16)) for a, t in re.findall(
        r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?BRA\s+(?:`\(\.L_x_\d+\)\s+)?"
        r"0x([0-9a-f]+)", fn) if int(t, 16) < int(a, 16)]
    start, end = back[-1][1], int(back[-1][0], 16)
    mix = collections.Counter(op for a, op in ins if start <= a <= end)
    return {"instructions": sum(mix.values()), "by_opcode": dict(
        mix.most_common())}


def launch_split(F, A, n_split: int):
    """The fp32 kernel on float32 F and A at a forced split count."""
    S, K = F.shape
    N = A.shape[1]
    out = torch.empty((S, N), device=F.device)
    ws = (torch.empty(n_split * S * N, device=F.device) if n_split > 1
          else None)
    rc = ops._spmm_fns()["fp32"](
        F.data_ptr(), 2, A.data_ptr(), 2, None, out.data_ptr(), 2, S, K, N,
        0, n_split, ws.data_ptr() if ws is not None else None,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_spmm_fp32_launch: CUDA error {rc}")
    return out


def host_us(calls: int = 200) -> float:
    """The wrapper's host time a call: ``calls`` launches at a shape whose
    device work is far shorter, timed on the host clock before the sync."""
    F = torch.rand((8, 64), device="cuda")
    A = torch.rand((64, 128), device="cuda")
    ops.block_spmm(F, A)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        ops.block_spmm(F, A)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> int:
    args = [a for a in sys.argv[1:]
            if a not in ("--checks", "--sweep", "--sass")]
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build.build("block_spmm")
    ptxas = build.build_log["block_spmm"]["ptxas"]
    if ptxas:                             # empty when built before
        print("this: " + fp32_report(ptxas))
    occ = {str(d): ops.spmm_fp32_blocks_per_sm(0, *d) for d in (
        (torch.float32, torch.float32, torch.float32),
        (torch.float32, torch.int32, torch.float32),
        (torch.int32, torch.float32, torch.float32),
        (torch.uint8, torch.float32, torch.uint8))}
    print("fp32 kernel blocks an SM " + json.dumps(occ), flush=True)
    if "--sass" in sys.argv:
        print("slab loop " + json.dumps(loop_mix(lib)), flush=True)
    if "--checks" in sys.argv:
        rec = chip_smoke.spmm_checks(ops, ref)
        print("phase 2 " + json.dumps({k: rec[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}),
            flush=True)
    others = {a: bind_other(Path(a).resolve() / SOURCE) for a in args}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, n in SHAPES.items():
        adj, h = operands(n, gen)
        rec = chip_smoke.spmm_fp32_check(ops, ref, adj, h,
                                         f"fp32 route at {name}")
        if "--sweep" in sys.argv:
            want = ref.block_spmm_ref(adj, h).cpu().numpy()
            rec["ms_by_n_split"] = {}
            for n_split in SWEEP[name]:
                chip_smoke.within(launch_split(adj, h, n_split).cpu().numpy(),
                                  want, *rec["tolerance"],
                                  f"{n_split} splits at {name}")
                rec["ms_by_n_split"][n_split] = chip_smoke.cuda_ms(
                    lambda: launch_split(adj, h, n_split), 20)
        out = torch.empty((n, 128), device="cuda")
        for path, other in others.items():
            chip_smoke.within(other(adj, h, out).cpu().numpy(),
                              ref.block_spmm_ref(adj, h).cpu().numpy(),
                              *rec["tolerance"], f"{path} at {name}")
            this = lambda: ops.block_spmm(adj, h)  # noqa: E731
            that = lambda: other(adj, h, out)  # noqa: E731
            turns = {path: [], "this": []}
            for key in (path, "this", "this", path):
                turns[key].append(chip_smoke.cuda_ms(
                    that if key == path else this, 20))
            rec.setdefault("turns_ms", []).append(turns)
        print(json.dumps({"view": name, **rec}), flush=True)
        del adj, h
        torch.cuda.empty_cache()
    print(json.dumps({"host_us_a_call": host_us()}))
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())

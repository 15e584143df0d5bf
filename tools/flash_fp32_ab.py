"""Time ``flash_attention``'s fp32 route on one card, and against other
checkouts.

    python3 tools/flash_fp32_ab.py [--sass] [--sweep] [OTHER_CHECKOUT ...]

Builds this checkout's ``src/repro_torch/kernels/csrc/flash_attention.cu``
through the port's builder and prints each fp32 kernel's registers and
spills (``-Xptxas -v``) and its resident blocks an SM at D = 64, 128 and
256; with ``--sass``, the instruction mix of ``flash_fp32_kernel<128>``
(``cuobjdump -sass``): the whole kernel and its kv-tile loop (the span of
its longest backward branch), with the width of every shared-memory load.
Then, at the fp32 route's timed shapes (``chip_smoke.ATTN_FP32_SHAPES``,
causal: (2, 4, 4, 256, 256, 128), starcoder2-3b's chunked decode and
prefill), it runs ``chip_smoke.attn_fp32_record``: the route held to the
plain version within ``ATTN_TOL`` and to a second launch bit for bit, its
planned split, and its time per call (CUDA events, host included) and on
the device (profiler: the kernel and the merge) beside its bound, the plain
version and SDPA on fp32 (TF32 off).  With ``--sweep`` it also times the
kernel at the decode shape at forced split counts around the plan's.  For
each OTHER_CHECKOUT given (unpack it with ``git archive`` into a directory
that ``.gitignore`` lists, such as ``build/``), it builds that checkout's
``flash_attention.cu`` (same flags, into ``build/ab/``), holds its fp32
entry to the plain version and times it per call and on the device in the
order other, this, this, other.  An fp32 entry without the split arguments
(the kernel before the split over keys) is bound too.  It prints one JSON
line per shape, then the card's name and power limit.  Compare two
versions only within one such run.
"""
import collections
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

SOURCE = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
# forced split counts of --sweep at the chunked decode shape (128 tiles)
SWEEP = (1, 3, 4, 5, 6, 8, 11, 16)


def fp32_report(ptxas: str) -> str:
    """Registers and spill stores of each fp32 kernel in a ``-Xptxas -v``
    report (``flash_fp32_kernel``, ``merge_kernel<float>``, or the older
    ``flash_kernel``)."""
    out, name, spill = [], None, "?"
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            name = re.search(r"(flash_fp32_kernel\w*?ILi\d+E|"
                             r"merge_kernelIfE|flash_kernelIf\w*?E)", line)
            name = name.group(1) if name else None
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spill} B spilled")
    return "; ".join(out)


def other_library(src: Path) -> Path:
    """Compile ``src`` with the port's flags into ``build/ab/`` unless
    built there already, printing its fp32 kernels' registers and spills."""
    out = ROOT / "build" / "ab" / (
        f"libflash_attention-"
        f"{hashlib.sha256(src.read_bytes()).hexdigest()[:12]}.so")
    if not out.exists():
        print(f"{src.parents[4].name}: "
              + fp32_report(build.compile_source(src, out)), flush=True)
    return out


def bind_other(src: Path, out: Path):
    """A ``run(q, k, v, out)`` that launches the fp32 entry of ``src``'s
    library ``out`` (where that entry takes a split, with this checkout's
    planner at that kernel's blocks an SM)."""
    lib = ctypes.CDLL(str(out))
    fn = lib.flash_attention_fp32_launch
    split = hasattr(lib, "flash_attention_fp32_blocks_per_sm")
    fn.argtypes = ([*[ctypes.c_void_p] * 6, *[ctypes.c_int] * 9,
                    ctypes.c_void_p] if split else
                   [*[ctypes.c_void_p] * 4, *[ctypes.c_int] * 7,
                    ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = {}
    if split:                    # the other kernel's own blocks an SM
        query = lib.flash_attention_fp32_blocks_per_sm
        query.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        for D in ops.HEAD_DIMS:
            blocks = ctypes.c_int(0)
            if query(D, ctypes.byref(blocks)) != 0 or blocks.value < 1:
                raise RuntimeError(f"{src}: occupancy query failed")
            occ[D] = blocks.value

    def run(q, k, v, out):
        B, Hq, Sq, D = q.shape
        Hkv, Sk = k.shape[1], k.shape[2]
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
        shape = [B, Hq, Hkv, Sq, Sk, D, 1]
        if not split:
            rc = fn(*ptrs, *shape, torch.cuda.current_stream().cuda_stream)
        else:
            n_split, per = ops.attention_splits(
                B, Hq, Sq, Sk, D, torch.cuda.get_device_properties(
                    q.device).multi_processor_count, ops.ATTN_FP32_BLOCK_Q,
                ops.ATTN_FP32_TILE_K, occ[D])
            rc = launch_split(fn, q, k, v, out, n_split, per)
        if rc != 0:
            raise RuntimeError(f"other flash_attention_fp32_launch: CUDA "
                               f"error {rc}")
        return out
    return run


def launch_split(fn, q, k, v, out, n_split: int, per: int) -> int:
    """An fp32 entry with the split arguments, causal, at a given split."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    ws_o = ws_ml = None
    if n_split > 1:
        rows = B * Hq * Sq
        ws_o = torch.empty((n_split, rows, D), device=q.device)
        ws_ml = torch.empty((2, n_split, rows), device=q.device)
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              ws_o.data_ptr() if ws_o is not None else None,
              ws_ml.data_ptr() if ws_ml is not None else None,
              B, Hq, Hkv, Sq, Sk, D, 1, n_split, per,
              torch.cuda.current_stream().cuda_stream)


def sass_mix(lib: Path) -> dict:
    """Opcode counts of ``flash_fp32_kernel<128>`` in the library's SASS:
    the whole kernel, and the span of its longest backward branch (the kv
    tile loop, which holds the d and key loops)."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    fn = next(p for p in re.split(r"\n\s*Function : ", sass)
              if "flash_fp32_kernelILi128E" in p.split("\n", 1)[0])
    ins = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+(?:\.[A-Z0-9_]+)*)",
        fn)]
    back = [(int(a, 16), int(t, 16)) for a, t in re.findall(
        r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?BRA\s+(?:`\(\.L_x_\d+\)\s+)?"
        r"0x([0-9a-f]+)", fn) if int(t, 16) < int(a, 16)]
    end, start = max(back, key=lambda b: b[0] - b[1])
    loop = collections.Counter(op for a, op in ins if start <= a <= end)
    whole = collections.Counter(op for _, op in ins)

    def span(lo, hi):
        ops_ = [op for a, op in ins if lo <= a <= hi]
        return {"instructions": len(ops_), "FFMA": ops_.count("FFMA"),
                "LDS.128": ops_.count("LDS.128")}
    return {"kernel": {"instructions": sum(whole.values()),
                       "FFMA": whole["FFMA"],
                       "shared_loads": {o: n for o, n in whole.items()
                                        if o.startswith("LDS")}},
            "tile_loop": {"instructions": sum(loop.values()),
                          "by_opcode": dict(loop.most_common())},
            # every loop (a backward branch), innermost first: the d and
            # key loops run D / 32 and 4 times a tile at unroll 8
            "loops": [span(t, a) for a, t in sorted(back,
                                                    key=lambda b: b[0] - b[1])]}


def qkv(shape, gen):
    B, Hq, Hkv, Sq, Sk, D = shape
    dev = torch.device("cuda")
    q = torch.randn((B, Hq, Sq, D), generator=gen, device=dev) * 0.5
    k = torch.randn((B, Hkv, Sk, D), generator=gen, device=dev) * 0.5
    v = torch.randn((B, Hkv, Sk, D), generator=gen, device=dev)
    return q, k, v


def main() -> int:
    args = [a for a in sys.argv[1:] if a not in ("--sass", "--sweep")]
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build.build("flash_attention")
    # empty when built before: compile once more for the report
    ptxas = build.build_log["flash_attention"]["ptxas"] or \
        build.compile_source(build.CSRC / "flash_attention.cu",
                             ROOT / "build" / "ab" / "libthis.so")
    print("this: " + fp32_report(ptxas))
    occ = {D: ops.attention_fp32_blocks_per_sm(0, D) for D in ops.HEAD_DIMS}
    print("fp32 kernel blocks an SM by head_dim " + json.dumps(occ),
          flush=True)
    if "--sass" in sys.argv:
        print("sass " + json.dumps(sass_mix(lib)), flush=True)
    srcs = [Path(a).resolve() / SOURCE for a in args]
    with ThreadPoolExecutor(max_workers=max(len(srcs), 1)) as pool:
        libs = list(pool.map(other_library, srcs))  # one nvcc each, at once
    others = {a: bind_other(src, lib)
              for a, src, lib in zip(args, srcs, libs)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape in chip_smoke.ATTN_FP32_SHAPES.items():
        q, k, v = qkv(shape, gen)
        rec = chip_smoke.attn_fp32_record(ops, ref, q, k, v, name)
        want = ref.flash_attention_ref(q, k, v)
        tol = chip_smoke.ATTN_TOL[torch.float32]
        if "--sweep" in sys.argv and name == "starcoder2-3b chunked decode":
            n_kv = -(-shape[4] // ops.ATTN_FP32_TILE_K)
            rec["sweep"] = {}
            for n in SWEEP:
                per = -(-n_kv // n)
                n_split = -(-n_kv // per)
                out = torch.empty_like(q)

                def forced():
                    rc = launch_split(ops._flash_fns()["fp32"], q, k, v, out,
                                      n_split, per)
                    if rc != 0:
                        raise RuntimeError(f"CUDA error {rc}")
                    return out
                chip_smoke.check(torch.allclose(forced(), want, *tol),
                                 f"{n_split} splits at {name}")
                rec["sweep"][f"{n_split} x {per}"] = {
                    "ms": chip_smoke.cuda_ms(forced, 20),
                    "device_ms": chip_smoke.device_ms(
                        forced, flush=False, per_launch=True)}
        out = torch.empty_like(q)
        for path, other in others.items():
            got = other(q, k, v, out)
            chip_smoke.check(torch.allclose(got, want, *tol),
                             f"{path} != plain at {name}")
            calls = {path: lambda: other(q, k, v, out),
                     "this": lambda: ops.flash_attention(q, k, v)}
            turns = {path: [], "this": []}
            for key in (path, "this", "this", path):
                turns[key].append({
                    "ms": chip_smoke.cuda_ms(calls[key], 10),
                    "device_ms": chip_smoke.device_ms(
                        calls[key], iters=10, flush=False, per_launch=True)})
            rec.setdefault("turns", []).append(turns)
        print(json.dumps({"at": name, **rec}), flush=True)
        del q, k, v, want, out
        torch.cuda.empty_cache()
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())

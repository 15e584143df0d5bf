"""Time ``segment_multi_agg``'s kernel in two checkouts, in turns, on one card.

    python3 tools/segment_agg_ab.py OTHER_CHECKOUT

Builds OTHER_CHECKOUT's ``src/repro_torch/kernels/csrc/segment_agg.cu``
beside this checkout's (same ``nvcc`` flags, into ``build/ab/``) and binds
both through their C entry point ``segment_agg_launch``, whose signature
both keep.  On the messages of ``chip_smoke.py``'s phase 5 (the SNB graph at
the generator's defaults and at ten times its sizes, PNA's width 75), in
fp32 and bf16, it times the two kernels on the device in the order other,
this, this, other (``chip_smoke.device_ms``: a profiler trace, the L2
flushed before each launch), checks that the two give the same four
outputs bit for bit, and prints one JSON line per shape and dtype, then
the card's name and power limit.  Compare two versions only within one
such run.
"""
import ctypes
import hashlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402

SOURCE = Path("src/repro_torch/kernels/csrc/segment_agg.cu")
DT = {torch.float32: 0, torch.bfloat16: 1}


def bind(src: Path):
    """Compile ``src`` with the port's flags and return its launch entry."""
    out = ROOT / "build" / "ab" / (
        f"libsegment_agg-{hashlib.sha256(src.read_bytes()).hexdigest()[:12]}"
        f".so")
    if not out.exists():
        build.compile_source(src, out)
    fn = ctypes.CDLL(str(out)).segment_agg_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   *[ctypes.c_void_p] * 4, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, m, valid):
    N, W, D = m.shape
    outs = torch.empty((4, N, D), dtype=torch.float32, device=m.device)

    def run():
        rc = fn(m.data_ptr(), DT[m.dtype], valid.data_ptr(),
                *[o.data_ptr() for o in outs], N, W, D, 1e-5,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"segment_agg_launch failed: CUDA error {rc}")
        return outs
    return run


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("segment_agg_ab: no CUDA device", file=sys.stderr)
        return 2
    fns = {"other": bind(Path(sys.argv[1]).resolve() / SOURCE),
           "this": bind(ROOT / SOURCE)}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, sizes in (("SNB", {}), ("SNB x10", chip_smoke.SNB_X10)):
        dst, msg_e, N = chip_smoke.snb_messages(gen, dev, **sizes)
        bucketed, valid = ops.bucketize_messages(dst, msg_e, N)
        n_valid = int(valid.sum())
        for dtype in DT:
            m = bucketed.to(dtype)
            runs = {k: launcher(fn, m, valid) for k, fn in fns.items()}
            a, b = (runs[k]().clone() for k in ("other", "this"))
            chip_smoke.check(torch.equal(a, b), f"the two kernels differ at "
                                                f"{name} {dtype}")
            ms = {"other": [], "this": []}
            for k in ("other", "this", "this", "other"):
                ms[k].append(chip_smoke.device_ms(runs[k], "agg_kernel"))
            need = chip_smoke.agg_bytes(valid, n_valid, m.shape[2],
                                        m.element_size())
            print(json.dumps({
                "shape": name, "dims": list(m.shape), "dtype": str(dtype),
                "device_ms": ms, "bound_ms": need / chip_smoke.PEAK_BYTES
                * 1e3, "bytes": need}), flush=True)
            del m, runs
        del bucketed, valid
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())

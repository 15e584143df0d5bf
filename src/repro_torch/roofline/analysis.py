"""Three-term roofline of a cell's per-rank program, counted on ``meta``
tensors: the port of ``repro.roofline.analysis``.

  compute term    = FLOPs       / (chips x peak FLOP/s of their type)
  memory term     = bytes       / (chips x HBM bandwidth)
  collective term = coll bytes  / (chips x link bandwidth)

The reference reads these off a compiled XLA program (``cost_analysis``
and the collectives of the post-SPMD HLO).  The port runs the cell's
per-rank program once, at rank 0 of a meta rank mesh
(``launch.mesh.make_meta_mesh``), on ``meta`` tensors, under one dispatch
mode that counts:

* FLOPs, by ``torch.utils.flop_counter``'s formulas (the matmuls,
  convolutions and attention kernels ``FlopCounterMode`` counts, which
  runs around the count and must agree with it), split by the first
  operand's dtype;
* bytes, the input plus output bytes of every aten op that is not a view:
  the eager program's own traffic, since eager does not fuse;
* collective bytes, the output bytes ``mesh.counts`` holds for every
  collective (what the reference's ``collective_bytes`` sums), by the
  axis each ran over;
* peak live bytes of the rank's tensors, each counted from the op that
  allocates it until it is released (the inputs live throughout).

Per-rank counts are scaled by the chip count to keep the reference's
global form.  The hardware constants are the NVIDIA H100 SXM data sheet's
(dense): 989 TFLOP/s bf16, 67 TFLOP/s fp32 (the port keeps TF32 off),
3.35 TB/s HBM3, NVLink 450 GB/s a direction inside an 8-card node and
50 GB/s a card across nodes.  Ranks are laid out row-major over the mesh,
8 to a node, and a collective is charged at the slowest link its axis
group spans.
"""
from __future__ import annotations

import re
import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

HW = {
    "peak_flops_bf16": 989e12,
    "peak_flops_fp32": 67e12,
    "hbm_bw": 3.35e12,
    "nvlink_bw": 450e9,
    "network_bw": 50e9,
    "cards_per_node": 8,
}

_COLL_RE = re.compile(
    r"=\s*([a-z0-9]+)\[([\d,]*)\][^=]*?"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)",
)

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Sum output bytes per collective kind from optimized HLO text."""
    out: Dict[str, float] = {}
    for m in _COLL_RE.finditer(hlo_text):
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        nbytes = _DTYPE_BYTES.get(dtype, 4)
        n = 1
        if dims.strip():
            for d in dims.split(","):
                if d:
                    n *= int(d)
        out[kind] = out.get(kind, 0.0) + float(n * nbytes)
    return out


def peak_flops(dtype: str) -> float:
    """The card's dense peak for operands of ``dtype`` (bf16 and fp16 on
    the tensor cores, anything else at the fp32 rate)."""
    return HW["peak_flops_bf16"] if dtype in ("bfloat16", "float16") \
        else HW["peak_flops_fp32"]


def link_bw(mesh, axis: str) -> float:
    """The slowest link of rank 0's group along ``axis``: NVLink when the
    group's ranks share an 8-card node, the network otherwise."""
    names = list(mesh.axis_names)
    stride = 1
    for a in names[names.index(axis) + 1:]:
        stride *= mesh.shape[a]
    last = (mesh.shape[axis] - 1) * stride
    node = HW["cards_per_node"]
    return HW["nvlink_bw"] if last // node == 0 else HW["network_bw"]


@dataclass
class RooflineReport:
    arch: str
    shape: str
    n_chips: int
    hlo_flops: float            # global (per-rank x chips)
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, float]
    model_flops: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    peak_memory_bytes: float = 0.0
    # global FLOPs by operand dtype (None: all at the bf16 peak) and
    # global collective bytes by link bandwidth (None: all on the network)
    flops_by_dtype: Optional[Dict[str, float]] = None
    coll_bytes_by_bw: Optional[Dict[float, float]] = field(default=None)

    def __post_init__(self):
        chips = self.n_chips
        by_dtype = self.flops_by_dtype or {"bfloat16": self.hlo_flops}
        self.compute_s = sum(f / (chips * peak_flops(d))
                             for d, f in by_dtype.items())
        self.memory_s = self.hlo_bytes / (chips * HW["hbm_bw"])
        by_bw = self.coll_bytes_by_bw or {HW["network_bw"]: self.coll_bytes}
        self.collective_s = sum(b / (chips * bw) for bw, b in by_bw.items())

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def step_time_bound_s(self) -> float:
        """Roofline step time (max of the three terms — full overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful compute vs the roofline bound: how close to peak a step
        would run if every term overlapped perfectly (1.0 = MODEL_FLOPS at
        the bf16 peak)."""
        ideal = self.model_flops / (self.n_chips * HW["peak_flops_bf16"])
        bound = self.step_time_bound_s
        return ideal / bound if bound > 0 else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "chips": self.n_chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_memory_bytes": self.peak_memory_bytes,
            "coll_breakdown": self.coll_breakdown,
        }


# ------------------------------------------------------------- the counter

def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _aliases(func) -> Tuple[bool, bool]:
    """(a view op, an in-place or out= op) from the op's schema."""
    view = write = False
    for r in func._schema.returns:
        if r.alias_info is not None:
            if r.alias_info.is_write:
                write = True
            else:
                view = True
    return view, write


class CountMode(TorchDispatchMode):
    """FLOPs by dtype, bytes of non-view ops, and live and peak bytes of
    the tensors ops allocate, for every aten op run under it."""

    def __init__(self, live_from=()):
        super().__init__()
        self.flops: Dict[str, float] = {}
        self.bytes = 0.0
        self.ops = 0
        self.live = float(sum(t.nbytes for t in _tensors(live_from)))
        self.peak = self.live

    def _release(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            first = next(_tensors(args), None)
            dt = str(first.dtype).replace("torch.", "") if first is not None \
                else "float32"
            self.flops[dt] = self.flops.get(dt, 0.0) + float(n)
        view, write = _aliases(func)
        if not view:
            ins = sum(t.nbytes for t in _tensors((args, kwargs)))
            outs = list(_tensors(out))
            self.bytes += ins + sum(t.nbytes for t in outs)
            if not write:
                for t in outs:
                    self.live += t.nbytes
                    weakref.finalize(t, self._release, t.nbytes)
                self.peak = max(self.peak, self.live)
        return out


@dataclass
class Counts:
    """One rank's counts of one run."""
    flops: float
    flops_by_dtype: Dict[str, float]
    bytes: float
    coll: Dict[str, float]            # output bytes by collective kind
    coll_by_bw: Dict[float, float]    # output bytes by link bandwidth
    coll_calls: Dict[str, int]
    peak_bytes: float
    ops: int


def count(fn, args, mesh) -> Counts:
    """Run ``fn(*args)`` (meta tensors, ``mesh`` a meta rank mesh) under
    the counting mode and ``FlopCounterMode``; the counts of this rank."""
    mesh.reset_counts()
    mesh.axis_out_bytes = {}
    flop_mode = FlopCounterMode(display=False)
    counter = CountMode(live_from=args)
    with flop_mode, counter:
        out = fn(*args)
    del out
    total = float(sum(counter.flops.values()))
    if total != float(flop_mode.get_total_flops()):
        raise RuntimeError(f"the dtype split {counter.flops} does not add "
                           f"up to FlopCounterMode's "
                           f"{flop_mode.get_total_flops()}")
    coll = {k: float(v["out_bytes"]) for k, v in mesh.counts.items()
            if k != "staged"}
    by_bw: Dict[float, float] = {}
    for axis, b in mesh.axis_out_bytes.items():
        bw = link_bw(mesh, axis)
        by_bw[bw] = by_bw.get(bw, 0.0) + float(b)
    return Counts(flops=total, flops_by_dtype=dict(counter.flops),
                  bytes=counter.bytes, coll=coll, coll_by_bw=by_bw,
                  coll_calls={k: v["calls"] for k, v in mesh.counts.items()
                              if k != "staged"},
                  peak_bytes=counter.peak, ops=counter.ops)


def raw_counts(cell, mesh) -> Tuple[float, float, Dict[str, float]]:
    """(flops, bytes, collective-bytes-by-kind) of rank 0's program, in the
    reference's ``raw_costs`` form (for :func:`extrapolate`)."""
    from repro_torch.launch.steps import local_inputs
    c = count(cell.fn, local_inputs(cell, cell.args, mesh), mesh)
    return c.flops, c.bytes, c.coll


def extrapolate(c_small: Tuple, c_big: Tuple, l_small: int, l_big: int,
                l_target: int) -> Tuple[float, float, Dict[str, float]]:
    """Linear per-layer extrapolation from two unrolled calibration builds."""
    span = l_big - l_small
    f = c_small[0] + (l_target - l_small) / span * (c_big[0] - c_small[0])
    b = c_small[1] + (l_target - l_small) / span * (c_big[1] - c_small[1])
    kinds = set(c_small[2]) | set(c_big[2])
    coll = {}
    for k in kinds:
        a0 = c_small[2].get(k, 0.0)
        a1 = c_big[2].get(k, 0.0)
        coll[k] = max(a0 + (l_target - l_small) / span * (a1 - a0), 0.0)
    return f, b, coll


def analyze_cell(cell, mesh, *, arch: str, shape: str,
                 counts: Optional[Counts] = None) -> RooflineReport:
    """The roofline of ``cell`` (built on the meta rank mesh ``mesh``) from
    rank 0's counts, scaled to the global form."""
    from repro_torch.launch.steps import local_inputs
    c = counts or count(cell.fn, local_inputs(cell, cell.args, mesh), mesh)
    n = mesh.size
    return RooflineReport(
        arch=arch, shape=shape, n_chips=n,
        hlo_flops=c.flops * n, hlo_bytes=c.bytes * n,
        coll_bytes=sum(c.coll.values()) * n, coll_breakdown=c.coll,
        model_flops=cell.model_flops_per_step, peak_memory_bytes=c.peak_bytes,
        flops_by_dtype={d: f * n for d, f in c.flops_by_dtype.items()},
        coll_bytes_by_bw={bw: b * n for bw, b in c.coll_by_bw.items()})

"""One run of one cell: build the graph, hand the window to the cell's loop,
then judge what the window produced against the plain reference and print
the result line.

Everything a cell needs is found by name (see ``mvbench/__init__.py``),
so a later change adds a configuration, a traffic mix, a loop, a generator
or a per-layer metric by adding files and ``BENCHMARK.json`` entries.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from mvbench.reference.check import check as reference_check
from mvbench.reference.paths import GraphState, sparse_row
from mvbench.trace import Capture, span

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# finding a cell's pieces by name
# ---------------------------------------------------------------------------

def plugin(kind: str, name: str, root: Path, paths: List[str]):
    """The module ``<path>/<kind>/<name>.py`` for the first of the
    benchmark's ``paths`` (then this folder) that has it."""
    for base in [root / p for p in paths] + [BENCH_DIR]:
        f = base / kind / f"{name}.py"
        if f.is_file():
            spec = importlib.util.spec_from_file_location(
                f"mvbench_{kind}_{name.replace('.', '_')}", f)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no {kind}/{name}.py under {paths}")


def data_file(kind: str, name: str, root: Path, paths: List[str]) -> dict:
    for base in [root / p for p in paths] + [BENCH_DIR]:
        f = base / kind / f"{name}.json"
        if f.is_file():
            return json.loads(f.read_text())
    raise FileNotFoundError(f"no {kind}/{name}.json under {paths}")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path
    paths: List[str]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = [w for w in bench["workloads"] if w["name"] == name]
    if not wl:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    wl = wl[0]
    entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    config = json.loads((root / entry["file"]).read_text())
    traffic = data_file("traffic", wl["traffic"], root, bench["paths"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moves)]
    return Cell(name, wl, config, traffic, e2e, per_layer, root,
                bench["paths"])


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def seed_rng(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per stream, the same for the same seed."""
    tag = int.from_bytes(stream.encode()[:8].ljust(8, b"\0"), "little")
    return np.random.default_rng([seed & (2 ** 64 - 1), tag])


class Run:
    """What a loop gets: the session on the card, the harness's own copy of
    the graph (``state``), the parsed reads and the log the reference will
    replay.  Loops add to ``oplog`` in submission order and fill
    ``e2e`` (end-to-end values), ``layer`` (counts for the per-layer
    readers), ``attempted`` and ``failed``."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, t0: float, control: bool = False):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.t0 = trace, device, t0
        self.control = control
        self.config, self.traffic = cell.config, cell.traffic
        self.oplog: list = []
        self.e2e: Dict[str, float] = {}
        self.layer: dict = {}
        self.attempted = self.failed = 0
        self.trace_summary: Optional[dict] = None
        self.diag: dict = {}

    # -- set-up ------------------------------------------------------------

    def build(self) -> None:
        from repro_torch.core import ExecConfig, GraphSession, parse_query
        from repro_torch.core.graph import GraphBuilder
        from repro_torch.core.schema import GraphSchema
        gen = self.config["generator"]
        mod = plugin("generators", gen["name"], self.cell.root,
                     self.cell.paths)
        parts = self.diag.setdefault("setup_parts_s", {})
        t = time.perf_counter()
        parts["start"] = t - self.t0
        with span("setup:generate"):
            self.data = mod.generate(seed_rng(self.seed, "data"),
                                     gen["sizes"])
        self.state = GraphState.from_data(self.data)
        schema = GraphSchema()
        b = GraphBuilder(schema)
        nl, el = self.data["node_labels"], self.data["edge_labels"]
        with span("setup:load"):
            for lab in self.data["node_label"].tolist():
                b.add_node(nl[lab])
            for s, d, lab in zip(self.data["src"].tolist(),
                                 self.data["dst"].tolist(),
                                 self.data["edge_label"].tolist()):
                b.add_edge(s, d, el[lab])
            g = b.finalize(slack=float(gen["slack"]), device=self.device)
        self.sess = GraphSession(g, schema, ExecConfig(**self.config["exec"]),
                                 device=self.device)
        self.sync()
        parts["graph"] = time.perf_counter() - t
        t = time.perf_counter()
        with span("setup:views"):
            for v in self.config["views"]:
                self.sess.create_view(v["cypher"])
        self.sync()
        parts["views"] = time.perf_counter() - t
        self.mark_peak("views")
        self.queries = []
        for r in self.config["reads"]:
            q = parse_query(r["cypher"])
            if self.control:
                q = dataclasses.replace(q, force_bool=True)
            self.queries.append(q)
        # every base edge's arena slot, by its id in ``state``
        self.slot_of: Dict[int, int] = {h: h for h in range(self.state.n_edges)}
        if self.trace:
            Capture.warm_up()

    def mark_peak(self, at: str) -> None:
        """Note the device's peak so far (where in the run it was set)."""
        if self.device != "cpu":
            self.diag.setdefault("peak_gib_after", {})[at] = (
                torch.cuda.max_memory_allocated() / 2 ** 30)

    def sync(self) -> None:
        if self.device != "cpu":
            torch.cuda.synchronize()

    # -- writes ------------------------------------------------------------

    def batch_of(self, fence):
        """The port's ``WriteBatch`` for a fence, or None while a slot it
        names is not known yet (its creating fence has not applied)."""
        from repro_torch.core import WriteBatch
        b = WriteBatch()
        for op in fence.ops:
            if op[0] == "create_edge":
                b.create_edge(op[1], op[2], op[3])
            elif op[0] == "delete_edge":
                if op[1] not in self.slot_of:
                    return None
                b.delete_edge(self.slot_of[op[1]])
            elif op[0] == "delete_node":
                b.delete_node(op[1])
            else:
                b.create_node(self.state.node_labels[
                    int(self.state.label_of_node[op[1]])], key=op[1])
        return b

    def applied(self, fence, result) -> None:
        """Record the arena slots a fence's creates got."""
        for h, slot in zip(fence.created, np.asarray(result.edge_slots)):
            self.slot_of[h] = int(slot)
        for op in fence.ops:
            if op[0] == "delete_edge":
                self.slot_of.pop(op[1], None)
        nodes = [op[1] for op in fence.ops if op[0] == "create_node"]
        if nodes and list(np.asarray(result.node_slots)) != nodes:
            raise RuntimeError(
                f"the port created nodes {list(result.node_slots)} for the "
                f"recover of {nodes}: the harness names nodes by id")

    # -- reads -------------------------------------------------------------

    @staticmethod
    def answer(res, sample_srcs=None) -> dict:
        """The part of a read's result that the reference will judge: its
        source ids and the rows of ``sample_srcs`` (all rows if None)."""
        ids = np.asarray(res.src_ids)
        pos = (np.arange(ids.shape[0]) if sample_srcs is None else
               np.flatnonzero(np.isin(ids, sample_srcs)))
        return {"src_ids": ids.copy(),
                "rows": {int(ids[p]): sparse_row(res.reach[p]) for p in pos}}


def jax_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def stored_view_pairs(sess) -> Dict[str, tuple]:
    """Each view's stored (src, dst, count) pairs, read from the program's
    arena after the window, to be judged."""
    alive = sess.g.edge_alive.cpu().numpy()
    weight = sess.g.edge_weight.cpu().numpy()
    out = {}
    for name, view in sess.views.items():
        keys = [(k, s) for k, s in view.pair_slot.items() if alive[s]]
        src = np.asarray([k[0] for k, _ in keys], np.int64)
        dst = np.asarray([k[1] for k, _ in keys], np.int64)
        cnt = (np.asarray([weight[s] for _, s in keys], np.int64)
               if view.counting else np.ones(len(keys), np.int64))
        out[name] = (src, dst, cnt)
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             control: bool = False) -> dict:
    """One run; returns the result object (the last line of a run)."""
    t0 = time.perf_counter() if t0 is None else t0
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    run = Run(cell, seed, seconds, trace, device, t0, control)
    run.build()
    loop = plugin("loops", cell.traffic["loop"], cell.root, cell.paths)
    loop.run(run)
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    stored = stored_view_pairs(run.sess)
    ctx = {"layer": run.layer, "trace": run.trace_summary}
    nnz = run.layer.get("nnz_of")
    del run.sess, loop
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = reference_check(run.data, cell.config["reads"],
                             cell.config["views"], run.oplog, stored, device)
    run.diag["reference_s"] = time.perf_counter() - t
    if nnz is not None:
        # a view label's edges are its pairs, as the reference derives them
        nnz.update(checks["view_pairs"])
    limits = {k: 0 for k in ("rows_wrong", "sources_wrong",
                             "view_pairs_wrong", "unanswered")}
    checks["unanswered"] = run.failed
    correct = (all(checks[k] <= v for k, v in limits.items())
               and checks["rows_compared"] > 0)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = plugin("metrics", m["name"], cell.root, cell.paths).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(run.e2e[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": dev}
    if trace and run.trace_summary is not None:
        ts = run.trace_summary
        dev["busy_s"], dev["window_s"] = ts["busy_s"], ts["window_s"]
        out["breakdown"] = {"device_ops": ts["device_ops"],
                            "idle_gaps": ts["idle_gaps"]}
    run.diag["reads_compared"] = checks["reads_compared"]
    out["diag"] = run.diag
    out["checks"] = {k: {"value": int(checks[k]), "limit": limits[k]}
                     for k in limits}
    out["checks"]["rows_compared"] = {"value": int(checks["rows_compared"]),
                                      "limit": "> 0"}
    return out

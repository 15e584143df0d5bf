"""Fixtures of the benchmark's CPU tests: a copy of ``BENCHMARK.json``
whose configurations are cut a hundredfold, in a temporary checkout, with
the SNB analytic cell that ``mvbench/`` holds the files of (its
configuration and generator) but that ``BENCHMARK.json`` leaves out until
its rate is steady on the card (PERF.md, Open questions)."""
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
HELD = "snb-analytic"


def add_held_cell(bench: dict) -> None:
    """The held cell's entries, as a later change would add them."""
    if HELD in {w["name"] for w in bench["workloads"]}:
        return
    bench["configs"].append({"name": "snb_x2", "source": "test",
                             "file": "mvbench/configs/snb_x2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": HELD, "config": "snb_x2",
                               "traffic": "paper_analytic", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "fin-analytic-dense" in m.get("workloads", []) and \
                m["name"] != "block_spmm_roofline":
            m["workloads"].append(HELD)


def shrink(root: Path, factor: int = 100) -> Path:
    """Write ``root/BENCHMARK.json`` and each configuration file, its
    node counts cut by ``factor`` (at least 4 of each label)."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    add_held_cell(bench)
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        sizes = cfg["generator"]["sizes"]
        for k in sizes:
            if k.startswith("n_"):
                sizes[k] = max(4, sizes[k] // factor)
        (root / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (root / c["file"]).write_text(json.dumps(cfg))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    return shrink(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def fresh_copy(tmp_path) -> Path:
    """A checkout holding only ``BENCHMARK.json`` and ``mvbench/``."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "mvbench", tmp_path / "mvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path

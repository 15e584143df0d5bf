"""A run of each cell end to end on the CPU at a hundredth of its size:
the result object the contract asks for, ``correct`` true."""
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import REPO
from mvbench import harness

CELLS = ["fin-analytic-dense", "snb-analytic"]


def run_tiny(root, name, trace=False, seconds=2.0, **kw):
    cell = harness.load_cell(name, root)
    return cell, harness.run_cell(cell, 2 ** 31 + 11, seconds, trace, "cpu",
                                  **kw)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(tiny_root, name, trace):
    cell, out = run_tiny(tiny_root, name, bool(trace))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    json.dumps(out)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] == 0 for k, c in out["checks"].items()
               if k != "rows_compared")
    assert out["checks"]["rows_compared"]["value"] > 0
    want = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in want}
    assert set(out["metrics"]) <= names
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # on the CPU no op runs on a device: the counters still read
        assert any(k.startswith("plan.pulls_per_read") for k in out["metrics"])
    else:
        assert set(out["metrics"]) == names
        assert out["metrics"]["setup_s"]["value"] > 0


def test_same_seed_same_inputs(tiny_root):
    cell = harness.load_cell("snb-analytic", tiny_root)
    gen = harness.plugin("generators", cell.config["generator"]["name"],
                         tiny_root, cell.paths)
    sizes = cell.config["generator"]["sizes"]
    a = gen.generate(harness.seed_rng(2 ** 31 + 5, "data"), sizes)
    b = gen.generate(harness.seed_rng(2 ** 31 + 5, "data"), sizes)
    c = gen.generate(harness.seed_rng(2 ** 31 + 6, "data"), sizes)
    assert all((a[k] == b[k]).all() for k in ("src", "dst", "edge_label"))
    assert a["src"].shape != c["src"].shape or (a["src"] != c["src"]).any()


def test_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    """In a process of its own (other tests import JAX): a whole run, then
    the modules it loaded, by whole top-level name."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from pathlib import Path\n"
        "from mvbench import harness\n"
        "cell = harness.load_cell('fin-analytic-dense', Path(%r))\n"
        "out = harness.run_cell(cell, 7, 1.0, False, 'cpu')\n"
        "print(out['correct'], harness.jax_loaded())\n"
        % (str(REPO), str(REPO / "src"), str(tiny_root)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"


def test_without_a_card_run_py_prints_no_result(fresh_copy):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot show")
    res = subprocess.run(
        [sys.executable, "mvbench/run.py", "--workload", "fin-analytic-dense",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=fresh_copy, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""

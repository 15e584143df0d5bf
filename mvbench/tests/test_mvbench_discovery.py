"""A cell that later work adds by files alone: a configuration, a traffic
mix and a per-layer metric that ``mvbench/`` does not hold, found by name
in another folder that ``BENCHMARK.json`` lists under ``paths``."""
import json

from mvbench import harness
from conftest import shrink


def test_cell_found_from_new_files(tmp_path):
    root = shrink(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    new = root / "morebench"
    (new / "configs").mkdir(parents=True)
    (new / "traffic").mkdir()
    (new / "metrics").mkdir()
    cfg = json.loads((root / "mvbench/configs/snb_x2.json").read_text())
    cfg["name"] = "snb_half_views"
    cfg["views"] = cfg["views"][:1]
    (new / "configs/snb_half_views.json").write_text(json.dumps(cfg))
    (new / "traffic/analytic_sampled.json").write_text(json.dumps(
        {"loop": "analytic_closed", "check_rows": 5}))
    (new / "metrics/passes.analytic.py").write_text(
        "def read(ctx):\n    return ctx['layer']['reads'] / 7\n")
    bench["paths"].append("morebench")
    bench["configs"].append({"name": "snb_half_views", "source": "test",
                             "file": "morebench/configs/snb_half_views.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "snb-half-analytic",
                               "config": "snb_half_views",
                               "traffic": "analytic_sampled", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "reads_per_s":
            m["workloads"].append("snb-half-analytic")
    bench["per_layer"].append({"name": "passes.analytic", "unit": "passes",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "reads_per_s",
                               "workloads": ["snb-half-analytic"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("snb-half-analytic", root)
    assert [m["name"] for m in cell.per_layer] == ["passes.analytic"]
    out = harness.run_cell(cell, 5, 1.0, True, "cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["passes.analytic"]["value"] >= 1
    out = harness.run_cell(cell, 5, 1.0, False, "cpu")
    assert set(out["metrics"]) == {"reads_per_s", "setup_s"}

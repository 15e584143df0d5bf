"""The check has to fail what it exists to catch.  The control (every read
in set semantics, the port's ``force_bool`` path) and three faults planted
under the timed path, each in a run that skips the look for a card: a
write that leaves the state unchanged, half of a batch's rows left out,
one answer altered where it is produced.  (Both cells run on one card, so
no exchange between cards can be left out.)"""
import numpy as np
import pytest

from mvbench import harness

CELLS = ["fin-analytic-dense", "snb-analytic"]


def run(root, name, **kw):
    cell = harness.load_cell(name, root)
    return harness.run_cell(cell, 2 ** 31 + 3, 1.5, False, "cpu", **kw)


def writes_unchanged(monkeypatch):
    from repro_torch.core.views import BatchResult, GraphSession

    def apply_writes(self, batch):
        return BatchResult(np.zeros(len(batch.edge_creates), np.int32),
                           np.asarray([k for _, k in batch.node_creates],
                                      np.int32))
    monkeypatch.setattr(GraphSession, "apply_writes", apply_writes)


def half_left_out(monkeypatch):
    from repro_torch.core import plan
    orig = plan._run_blocks

    def run_blocks(*a, **k):
        reach, db, rows = orig(*a, **k)
        reach[reach.shape[0] // 2:] = 0
        return reach, db, rows
    monkeypatch.setattr(plan, "_run_blocks", run_blocks)


def answer_altered(monkeypatch):
    from repro_torch.core import plan
    orig = plan._run_blocks

    def run_blocks(*a, **k):
        reach, db, rows = orig(*a, **k)
        if reach.size:
            reach[0, 0] += 1
        return reach, db, rows
    monkeypatch.setattr(plan, "_run_blocks", run_blocks)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(tiny_root, name):
    out = run(tiny_root, name, control=True)
    assert out["correct"] is False
    assert out["checks"]["rows_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", [writes_unchanged, half_left_out,
                                   answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails(tiny_root, monkeypatch, name, fault):
    fault(monkeypatch)
    out = run(tiny_root, name)
    assert out["correct"] is False, out["checks"]

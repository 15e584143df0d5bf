"""The batch pull on a card: a read's rows land in page-locked memory from
PyTorch's caching pinned-host allocator, and that memory is the result.

Each case needs a CUDA device and skips without one; on the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_pinned_pull.py``.
The rows are held to the port's own host session on the same graph (the
CPU tests hold that one to the reference)."""
import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as P
from repro_torch.utils import trace

READS = ("MATCH (a:A)-[e:x*1..2]->(d:B) WHERE a.age >= 3 RETURN a, d",
         "MATCH (a:A)-[e:x*1..]->(d:B) RETURN a, d",
         "MATCH (a:A)-[:x]->(m:B)-[:y]->(c) RETURN a, c")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def build(device, cfg=None, seed=0, n=64):
    rng = np.random.default_rng(seed)
    schema = P.GraphSchema()
    b = P.GraphBuilder(schema)
    for i in range(n):
        b.add_node(("A", "B")[i % 2], props={"age": int(rng.integers(0, 8))})
    for u in range(n):
        for v in range(n):
            if u != v and rng.random() < 0.1:
                b.add_edge(u, v, ("x", "y")[int(rng.integers(2))],
                           props={"w": int(rng.integers(0, 5))})
    return P.GraphSession(b.finalize(edge_cap=1024, device=device), schema,
                          cfg, device=device)


def owner(a):
    """The object that holds an ndarray's memory."""
    while isinstance(a, np.ndarray):
        a = a.base
    return a


def pull_span(fn):
    """``fn()`` under a profiler: (its result, its one ``exec.pull`` span)."""
    with trace.span("untraced"):          # found off: ends the last stretch
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    (pull,) = [r for r in trace.spans() if r.name == "exec.pull"]
    return out, pull


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [P.ExecConfig(), P.ExecConfig(
    backend="dense", use_kernel=True)], ids=["segment", "dense-kernel"])
def test_card_rows_are_pinned_and_equal_the_hosts(card, cfg):
    on_card, on_host = build("cuda", cfg), build("cpu", cfg)
    for q in READS:
        got, want = on_card.query(q), on_host.query(q)
        assert got.reach.dtype == want.reach.dtype == (
            np.int32 if got.counting else np.bool_)
        assert got.reach.flags.c_contiguous
        assert got.reach.shape == (got.src_ids.shape[0], on_card.g.node_cap)
        np.testing.assert_array_equal(got.src_ids, want.src_ids)
        np.testing.assert_array_equal(got.reach, want.reach, err_msg=q)
        pinned = owner(got.reach)
        assert isinstance(pinned, torch.Tensor), q
        assert pinned.device.type == "cpu" and pinned.is_pinned(), q


@pytest.mark.cuda
def test_a_kept_result_keeps_its_block_and_a_dropped_one_is_reused(card):
    sess = build("cuda")
    sess.query(READS[0])                                   # warm the caches
    kept = sess.query(READS[0])
    copy = kept.reach.copy()
    second, pull = pull_span(lambda: sess.query(READS[0]))
    assert not np.shares_memory(kept.reach, second.reach)
    assert pull.attrs["pinned_new"] in (0, 1)
    del second
    gc.collect()
    third, pull = pull_span(lambda: sess.query(READS[0]))
    assert pull.attrs["pinned_new"] == 0           # the dropped block, again
    assert not np.shares_memory(kept.reach, third.reach)
    np.testing.assert_array_equal(kept.reach, copy)
    np.testing.assert_array_equal(third.reach, copy)

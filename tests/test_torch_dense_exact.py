"""The port's dense hop is exact in integers, as the reference's is.

On a complete digraph of 70 ``A`` nodes, ``MATCH (a:A)-[:x*5..5]->(b:A)``
counts up to 22,343,305 walks between a pair, above the 2^24 where an fp32
product starts to round.  The default ``ExecConfig()`` picks the dense hop
there (70 nodes, density near 1), and so do ``plan_backend="dense"`` and
the unfused ``PathExecutor(backend="dense")``: each must equal the
reference's int32 answer cell for cell.  At ``*7..7`` the counts pass 2^31
and must wrap to int32 exactly as the reference's int32 product wraps.  On
the card the same three configs must give the closed-form counts.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as P

N = 70


def complete_digraph(pkg, device="cpu"):
    schema = pkg.GraphSchema()
    b = pkg.GraphBuilder(schema)
    for _ in range(N):
        b.add_node("A")
    for u in range(N):
        for v in range(N):
            if u != v:
                b.add_edge(u, v, "x")
    kw = {"device": device} if pkg is P else {}
    return b.finalize(**kw), schema


def walks(n: int, k: int) -> np.ndarray:
    """Closed form of the ``k``-walk counts of the complete digraph on
    ``n`` nodes: ``((n-1)^k + (n-1)(-1)^k) / n`` on the diagonal and
    ``((n-1)^k - (-1)^k) / n`` off it."""
    diag = ((n - 1) ** k + (n - 1) * (-1) ** k) // n
    off = ((n - 1) ** k - (-1) ** k) // n
    return np.where(np.eye(n, dtype=bool), diag, off)


def port_reach(q: str, how: str, device="cpu") -> np.ndarray:
    g, schema = complete_digraph(P, device)
    if how == "unfused dense":
        ex = P.PathExecutor(g, schema, P.ExecConfig(backend="dense"))
        return ex.run_query(P.parse_query(q)).reach
    cfg = P.ExecConfig() if how == "default" else P.ExecConfig(
        plan_backend="dense")
    sess = P.GraphSession(g, schema, cfg, device=device)
    return sess.query(q, use_views=False).reach


@pytest.fixture(scope="module")
def reference():
    R = pytest.importorskip("repro.core")
    g, schema = complete_digraph(R)
    sess = R.GraphSession(g, schema)
    return {k: sess.query(f"MATCH (a:A)-[:x*{k}..{k}]->(b:A)",
                          use_views=False).reach for k in (5, 7)}


def test_default_config_goes_dense_here():
    from repro_torch.core.plan import _choose_backend
    g, schema = complete_digraph(P)
    sess = P.GraphSession(g, schema, device="cpu")
    lid = schema.edge_labels.id_of("x")
    assert _choose_backend(sess.engine, sess.cfg, lid) == "dense"


@pytest.mark.parametrize("how", ["default", "plan dense", "unfused dense"])
@pytest.mark.parametrize("k", [5, 7])
def test_dense_counts_equal_reference(reference, how, k):
    want = reference[k]
    got = port_reach(f"MATCH (a:A)-[:x*{k}..{k}]->(b:A)", how)
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape and want.shape[0] == N
    exact = walks(N, k)
    np.testing.assert_array_equal(want[:, :N], exact.astype(np.int32))
    assert not want[:, N:].any()
    if k == 5:
        assert exact.max() == 22_343_305 and (exact >= 2 ** 24).all()
    else:
        assert (exact >= 2 ** 31).all()      # every cell wraps
    np.testing.assert_array_equal(got, want, err_msg=f"{how}, *{k}..{k}")


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["default", "plan dense", "unfused dense"])
@pytest.mark.parametrize("k", [5, 7])
def test_dense_counts_exact_on_the_card(how, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = port_reach(f"MATCH (a:A)-[:x*{k}..{k}]->(b:A)", how, "cuda")
    np.testing.assert_array_equal(got[:, :N], walks(N, k).astype(np.int32))
    assert not got[:, N:].any()

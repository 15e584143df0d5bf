"""Share of the dense slabs that ``block_spmm``'s u8 route walked in the
reads, in percent: the ``spmm_live_slabs`` over the ``spmm_dense_slabs``
that the port's launches add to the spans under its ``session.query``
spans, in the traced pass (``mvbench/spans.py``).  A dense slab is one
(block, 64-row K slab) pair of a launch, walked or not; a walked one holds
a non-zero of A.  Nothing where no launch carries the counts."""
from mvbench.spans import totals


def read(ctx):
    t = totals("session.query")
    if t is None:
        return None
    live = sum(s.get("spmm_live_slabs", 0) for s in t.values())
    dense = sum(s.get("spmm_dense_slabs", 0) for s in t.values())
    if not dense:
        return None
    return 100.0 * live / dense

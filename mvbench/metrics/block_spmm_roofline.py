"""``block_spmm``'s share of its roofline over the traced pass, in percent:
the sum over its launches of the least time each hop needs
(``mvbench/hop_count.py``: operations over the int8 tensor-core peak or
bytes over the memory rate, whichever is larger, from the hop's shape,
semantics and the live edge count of its label) over the device time of
``block_spmm``'s kernels in the trace.  A launch whose label the harness
cannot name fails the run rather than leave the share unmeasured."""
from mvbench.hop_count import hop_least_s


def read(ctx):
    lay, tr = ctx["layer"], ctx.get("trace")
    hops = lay.get("hops")
    if not hops or not tr or not tr["kernel_s"].get("block_spmm"):
        return None
    nnz = lay["nnz_of"]
    missing = {lab for *_, lab in hops if lab not in nnz}
    if missing:
        raise RuntimeError(f"block_spmm launches over unknown labels "
                           f"{sorted(missing)}")
    least = sum(hop_least_s(S, K, N, nnz[lab], counting)
                for S, K, N, counting, lab in hops)
    return 100.0 * least / tr["kernel_s"]["block_spmm"]

"""What the harness reads from the program around its calls into each
layer: the port's own counters, and in a traced run a record of each dense
hop that goes to ``block_spmm`` (its shape, semantics and edge label)."""
from __future__ import annotations

from typing import List, Tuple


def counters() -> dict:
    """The port's host-pull counters and ``block_spmm``'s launch count."""
    from repro_torch.kernels import ops
    from repro_torch.utils.device import host, host_flag
    return {"pulls": host.calls + host_flag.calls,
            "spmm_launches": ops.block_spmm.launches}


class HopRecorder:
    """Records every kernel hop (``_hop_kernel``, the call from the planner
    and executor into ``block_spmm``) while open: ``(S, K, N, counting,
    label)``, the label found by the adjacency's identity in the session
    engine's cache at the time of the call."""

    def __init__(self, sess):
        self.sess = sess
        self.launches: List[Tuple[int, int, int, bool, str]] = []
        self._saved = []

    def _label(self, A) -> str:
        ptr = A.data_ptr()
        for key, (_, adj) in self.sess.engine._adj_cache.items():
            if adj.data_ptr() == ptr:
                return self.sess.schema.edge_labels.name_of(key[0])
        return "?"

    def __enter__(self):
        from repro_torch.core import executor, plan
        orig = executor._hop_kernel

        def hop(F, A, *, counting):
            self.launches.append((int(F.shape[0]), int(F.shape[1]),
                                  int(A.shape[1]), bool(counting),
                                  self._label(A)))
            return orig(F, A, counting=counting)

        for mod in (executor, plan):
            self._saved.append((mod, mod._hop_kernel))
            mod._hop_kernel = hop
        return self

    def __exit__(self, *exc):
        for mod, fn in self._saved:
            mod._hop_kernel = fn
        self._saved.clear()
        return False

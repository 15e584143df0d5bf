from repro_torch.graphops.csr import build_csr, compact_coo, ell_from_coo

__all__ = ["build_csr", "compact_coo", "ell_from_coo"]

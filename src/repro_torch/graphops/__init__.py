from repro_torch.graphops.csr import compact_coo

__all__ = ["compact_coo"]

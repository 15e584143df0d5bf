"""pna: 4L d_hidden=75, aggregators mean-max-min-std, scalers id-amp-atten
[arXiv:2004.05718; paper]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.gnn.pna import PNAConfig


def full() -> PNAConfig:
    return PNAConfig(name="pna", n_layers=4, d_hidden=75, d_in=1433,
                     n_classes=47, avg_degree=4.0)


def smoke() -> PNAConfig:
    return PNAConfig(name="pna-smoke", n_layers=2, d_hidden=16, d_in=8,
                     n_classes=4, avg_degree=3.0)


SPEC = ArchSpec(arch_id="pna", family="gnn", model="pna",
                full=full, smoke=smoke, source="arXiv:2004.05718")

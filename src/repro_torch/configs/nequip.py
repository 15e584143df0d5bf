"""nequip: 5L d_hidden=32 l_max=2 n_rbf=8 cutoff=5, E(3) tensor product
[arXiv:2101.03164; paper]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.gnn.nequip import NequIPConfig


def full() -> NequIPConfig:
    return NequIPConfig(name="nequip", n_layers=5, d_hidden=32, l_max=2,
                        n_rbf=8, cutoff=5.0, n_types=64)


def smoke() -> NequIPConfig:
    return NequIPConfig(name="nequip-smoke", n_layers=2, d_hidden=8, l_max=2,
                        n_rbf=4, cutoff=5.0, n_types=8)


SPEC = ArchSpec(arch_id="nequip", family="gnn", model="nequip",
                full=full, smoke=smoke, source="arXiv:2101.03164")

"""mace: 2L d_hidden=128 l_max=2 correlation=3 n_rbf=8, E(3)-ACE
[arXiv:2206.07697; paper]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.gnn.mace import MACEConfig


def full() -> MACEConfig:
    return MACEConfig(name="mace", n_layers=2, d_hidden=128, l_max=2,
                      correlation_order=3, n_rbf=8, cutoff=5.0, n_types=64)


def smoke() -> MACEConfig:
    return MACEConfig(name="mace-smoke", n_layers=2, d_hidden=16, l_max=2,
                      correlation_order=3, n_rbf=4, cutoff=5.0, n_types=8)


SPEC = ArchSpec(arch_id="mace", family="gnn", model="mace",
                full=full, smoke=smoke, source="arXiv:2206.07697")

"""dimenet: 6 blocks d_hidden=128 n_bilinear=8 n_spherical=7 n_radial=6
[arXiv:2003.03123; unverified]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.gnn.dimenet import DimeNetConfig


def full() -> DimeNetConfig:
    return DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                         n_bilinear=8, n_spherical=7, n_radial=6, cutoff=5.0,
                         n_types=64)


def smoke() -> DimeNetConfig:
    return DimeNetConfig(name="dimenet-smoke", n_blocks=2, d_hidden=24,
                         n_bilinear=4, n_spherical=3, n_radial=3, cutoff=5.0,
                         n_types=8)


SPEC = ArchSpec(arch_id="dimenet", family="gnn", model="dimenet",
                full=full, smoke=smoke, source="arXiv:2003.03123")

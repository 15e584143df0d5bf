"""Configurations: the paper's workload (views, reads and write mix, in
``configs.mv4pg``) and the architecture registry of the side stacks:
``--arch <id>`` resolves here, to the reference's ten architectures under
the reference's ids."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (
    dimenet, gemma_2b, mace, mind, nequip, pna, qwen2_moe_a2_7b,
    qwen3_moe_235b_a22b, starcoder2_3b, yi_34b,
)
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import shapes_for

ARCHS: Dict[str, ArchSpec] = {
    spec.arch_id: spec
    for spec in [
        yi_34b.SPEC, starcoder2_3b.SPEC, gemma_2b.SPEC,
        qwen2_moe_a2_7b.SPEC, qwen3_moe_235b_a22b.SPEC,
        pna.SPEC, nequip.SPEC, dimenet.SPEC, mace.SPEC, mind.SPEC,
    ]
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells():
    """Every (arch, shape) cell — 40 total."""
    for arch_id, spec in ARCHS.items():
        for shape_name in shapes_for(spec.family):
            yield arch_id, shape_name

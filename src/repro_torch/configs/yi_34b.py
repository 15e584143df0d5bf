"""yi-34b: 60L d7168 56H (GQA kv=8) d_ff=20480 vocab=64000 — llama-arch GQA
[arXiv:2403.04652; hf]."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab=64000, head_dim=128, act="swiglu",
        rope_theta=5_000_000.0, tie_embeddings=False, dtype=torch.bfloat16)


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="yi-34b-smoke", n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab=512, head_dim=16, act="swiglu",
        tie_embeddings=False, remat=False)


SPEC = ArchSpec(arch_id="yi-34b", family="lm", model="transformer",
                full=full, smoke=smoke, source="arXiv:2403.04652")

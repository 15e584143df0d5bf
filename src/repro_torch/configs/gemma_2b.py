"""gemma-2b: 18L d2048 8H (MQA kv=1) d_ff=16384 vocab=256000 — GeGLU,
head_dim=256, embedding scaling [arXiv:2403.08295; hf]."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="gemma-2b", n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
        d_ff=16384, vocab=256000, head_dim=256, act="geglu",
        rope_theta=10_000.0, tie_embeddings=True, embed_scale=True,
        dtype=torch.bfloat16)


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="gemma-2b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=256, vocab=512, head_dim=32, act="geglu",
        embed_scale=True, remat=False)


SPEC = ArchSpec(arch_id="gemma-2b", family="lm", model="transformer",
                full=full, smoke=smoke, source="arXiv:2403.08295")

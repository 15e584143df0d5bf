"""starcoder2-3b: 30L d3072 24H (GQA kv=2) d_ff=12288 vocab=49152 — GQA, RoPE
[arXiv:2402.19173; hf]."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-3b", n_layers=30, d_model=3072, n_heads=24,
        n_kv_heads=2, d_ff=12288, vocab=49152, head_dim=128, act="swiglu",
        rope_theta=999_999.0, tie_embeddings=True, dtype=torch.bfloat16)


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-3b-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=192, vocab=384, head_dim=16, act="swiglu",
        remat=False)


SPEC = ArchSpec(arch_id="starcoder2-3b", family="lm", model="transformer",
                full=full, smoke=smoke, source="arXiv:2402.19173")

"""qwen3-moe-235b-a22b: 94L d4096 64H (GQA kv=4) expert d_ff=1536
vocab=151936, MoE 128 routed top-8 [assignment spec].

The reference shards its 128 experts 16-way over a model axis (expert
parallelism); the port's expert-parallel layer runs its MoE over a rank
mesh, and the sharding rules (``launch/sharding.py``) place its full
parameters; the port runs the smoke config end to end on one device."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
        n_kv_heads=4, d_ff=0, vocab=151936, head_dim=128, act="swiglu",
        rope_theta=1_000_000.0, tie_embeddings=False, dtype=torch.bfloat16,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536,
                      n_shared_experts=0, capacity_factor=1.25))


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=0, vocab=512, head_dim=16, act="swiglu",
        tie_embeddings=False, remat=False,
        moe=MoEConfig(n_experts=8, top_k=8, d_ff_expert=32,
                      capacity_factor=2.0))


SPEC = ArchSpec(arch_id="qwen3-moe-235b-a22b", family="lm",
                model="transformer", full=full, smoke=smoke,
                source="hf:Qwen/Qwen3-30B-A3B (scaled per assignment)")

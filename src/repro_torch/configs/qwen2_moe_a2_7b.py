"""qwen2-moe-a2.7b: 24L d2048 16H (kv=16) expert d_ff=1408 vocab=151936,
MoE 60 routed top-4 + 4 shared [hf:Qwen/Qwen1.5-MoE-A2.7B].

Expert count 60 is not divisible by a 16-way model axis, so the
reference shards this arch with *tensor-parallel experts* (d_model/d_ff
sharded, expert axis replicated).  The port's expert-parallel layer
(``models/moe_sharded.py``) runs its MoE over a rank mesh whose model axis
divides 60, or pads the experts (``n_experts_alloc``) as the reference's
cells do; whole-model sharded steps are ROADMAP A11.6d."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=0, vocab=151936, head_dim=128, act="swiglu",
        rope_theta=1_000_000.0, tie_embeddings=True, dtype=torch.bfloat16,
        moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                      n_shared_experts=4, capacity_factor=1.25))


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=0, vocab=512, head_dim=16, act="swiglu",
        remat=False,
        moe=MoEConfig(n_experts=6, top_k=4, d_ff_expert=32,
                      n_shared_experts=4, capacity_factor=2.0))


SPEC = ArchSpec(arch_id="qwen2-moe-a2.7b", family="lm", model="transformer",
                full=full, smoke=smoke, source="hf:Qwen/Qwen1.5-MoE-A2.7B")

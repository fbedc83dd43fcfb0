"""Granite-MoE-3B-A800M: 40-expert top-8 fine-grained MoE.
[hf:ibm-granite/granite-3.0 family; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
        n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155,
        mlp="swiglu",
        moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="granite-moe-3b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=64, vocab=512,
        mlp="swiglu", dtype="float32",
        moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=64))

"""Hymba-1.5B: hybrid — attention heads in parallel with mamba (SSM) heads
inside each block; GQA kv=5. Meta-tokens omitted (DESIGN.md). [arXiv:2411.13676]"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
        n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001,
        mlp="swiglu", hybrid_parallel=True,
        ssm=SSMConfig(state_dim=16, expand=2, conv_width=4))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="hymba-1.5b-smoke", family="hybrid", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
        mlp="swiglu", hybrid_parallel=True, dtype="float32",
        ssm=SSMConfig(state_dim=8, expand=2, conv_width=4))

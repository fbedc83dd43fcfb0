"""Gemma-7B: GeGLU, head_dim=256 (q_dim 4096 != d_model 3072). [arXiv:2403.08295]"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="gemma-7b", family="dense", n_layers=28, d_model=3072,
        n_heads=16, n_kv_heads=16, head_dim=256, d_ff=24576, vocab=256000,
        mlp="geglu")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="gemma-7b-smoke", family="dense", n_layers=2, d_model=96,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
        mlp="geglu", dtype="float32")

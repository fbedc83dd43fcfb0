"""Qwen2.5-14B: dense GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B family; hf]"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=13824, vocab=152064,
        mlp="swiglu", qkv_bias=True, rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2.5-14b-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
        mlp="swiglu", qkv_bias=True, dtype="float32")

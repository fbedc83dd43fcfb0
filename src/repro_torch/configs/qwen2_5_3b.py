"""Qwen2.5-3B: dense GQA (kv=2), QKV bias. [hf:Qwen/Qwen2.5-0.5B family; hf]"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
        n_heads=16, n_kv_heads=2, d_ff=11008, vocab=151936,
        mlp="swiglu", qkv_bias=True, rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2.5-3b-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=1, d_ff=256, vocab=512,
        mlp="swiglu", qkv_bias=True, dtype="float32")

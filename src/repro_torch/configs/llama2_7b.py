"""Llama-2-7B — the paper's primary evaluation model. [arXiv:2307.09288]"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="llama2-7b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=32, d_ff=11008, vocab=32000, mlp="swiglu")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="llama2-7b-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, mlp="swiglu",
        dtype="float32")

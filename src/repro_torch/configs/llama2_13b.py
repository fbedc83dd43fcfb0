"""Llama-2-13B — the paper's kernel-benchmark model (Fig. 6/7). [arXiv:2307.09288]"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="llama2-13b", family="dense", n_layers=40, d_model=5120,
        n_heads=40, n_kv_heads=40, d_ff=13824, vocab=32000, mlp="swiglu")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="llama2-13b-smoke", family="dense", n_layers=2, d_model=160,
        n_heads=5, n_kv_heads=5, d_ff=320, vocab=512, mlp="swiglu",
        dtype="float32")

"""Nemotron-4-15B: GQA, squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=24576, vocab=256000,
        mlp="sq_relu", norm="ln")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="nemotron-4-15b-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
        mlp="sq_relu", norm="ln", dtype="float32")

"""Mixtral-8x22B: 8-expert top-2 MoE, GQA, SWA. [arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768,
        mlp="swiglu", sliding_window=4096, rope_theta=1e6,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="mixtral-8x22b-smoke", family="moe", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
        mlp="swiglu", sliding_window=64, dtype="float32",
        # capacity_factor = n_experts makes smoke routing drop-free, so the
        # capacity-batched train/prefill path and the per-token gather decode
        # path agree exactly (prefill/decode parity tests rely on this; the
        # full config keeps the published 1.25)
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=256,
                      capacity_factor=4.0))

"""LLaVA-NeXT (Mistral-7B backbone): anyres tiling stubbed — input_specs()
provides precomputed patch embeddings. [hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000,
        mlp="swiglu", vision_tokens=576)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="llava-next-mistral-7b-smoke", family="vlm", n_layers=2,
        d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
        mlp="swiglu", vision_tokens=16, dtype="float32")

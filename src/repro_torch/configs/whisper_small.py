"""Whisper-small: encoder-decoder; conv audio frontend stubbed (input_specs()
provides precomputed frame embeddings, enc_seq=1500). Sinusoidal positions,
LayerNorm, GELU. [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="whisper-small", family="encdec", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865,
        mlp="gelu", norm="ln", rope=False,
        is_encoder_decoder=True, enc_layers=12, enc_seq=1500)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="whisper-small-smoke", family="encdec", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        mlp="gelu", norm="ln", rope=False, dtype="float32",
        is_encoder_decoder=True, enc_layers=2, enc_seq=30)

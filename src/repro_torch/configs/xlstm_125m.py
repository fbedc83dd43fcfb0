"""xLSTM-125M: mLSTM + sLSTM blocks (no attention, no KV cache — Loki is
inapplicable by construction, see DESIGN.md §Arch-applicability).
[arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="xlstm-125m", family="ssm", n_layers=12, d_model=768,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
        rope=False, slstm_every=6,          # ~7:1 mLSTM:sLSTM mix
        ssm=SSMConfig(state_dim=16, n_heads=4))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="xlstm-125m-smoke", family="ssm", n_layers=4, d_model=64,
        n_heads=2, n_kv_heads=2, d_ff=0, vocab=512,
        rope=False, slstm_every=2, dtype="float32",
        ssm=SSMConfig(state_dim=8, n_heads=2))

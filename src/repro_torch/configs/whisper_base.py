"""Whisper base [arXiv:2212.04356] — enc-dec; mel+conv frontend stubbed to
precomputed frame embeddings (B, 1500, 512)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base", family="encdec", source="arXiv:2212.04356",
    n_layers=6, n_enc_layers=6, enc_len=1500,
    d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51865, act="gelu", norm="layernorm",
    fl_mapping="cohort",
))

"""Mamba2 130M [arXiv:2405.21060] — SSD (state-space duality), attn-free."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m", family="ssm", source="arXiv:2405.21060",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, tie_embeddings=True, norm="rmsnorm",
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=128,
    fl_mapping="cohort",
))

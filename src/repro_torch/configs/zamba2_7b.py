"""Zamba2 7B [arXiv:2411.15242] — Mamba2 backbone + weight-shared attention
block applied every 6 SSM layers (81 layers total)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b", family="hybrid", source="arXiv:2411.15242",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, act="geglu",
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_chunk=128,
    hybrid_attn_every=6, sliding_window=0,
    fl_mapping="cohort",
))

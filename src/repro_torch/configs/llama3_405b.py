"""Llama-3.1 405B [arXiv:2407.21783] — GQA kv=8, 128k vocab."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3-405b", family="dense", source="arXiv:2407.21783",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
    d_ff=53248, vocab=128256, act="silu", rope_theta=500000.0,
    fl_mapping="silo",
))

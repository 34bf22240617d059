"""Nemotron-4 15B [arXiv:2402.16819] — GQA kv=8, squared-ReLU MLP."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-15b", family="dense", source="arXiv:2402.16819",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=256000, act="sqrelu", norm="layernorm",
    rope_theta=10000.0, fl_mapping="cohort",
))

"""StableLM-2 1.6B [hf:stabilityai/stablelm-2-1_6b]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-1.6b", family="dense", source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab=100352, act="silu", norm="layernorm", rope_theta=10000.0,
    fl_mapping="cohort",
))

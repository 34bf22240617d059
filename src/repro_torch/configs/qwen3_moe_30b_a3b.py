"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128 experts top-8."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe", source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936, act="silu", rope_theta=1000000.0,
    n_experts=128, moe_top_k=8, n_shared_experts=0, d_expert=768, moe_impl="scatter",
    fl_mapping="silo",
))

"""Qwen2-VL 72B [arXiv:2409.12191] — M-RoPE, dynamic-resolution ViT stubbed
to precomputed patch embeddings (d_patch=1280, the ViT hidden size)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b", family="vlm", source="arXiv:2409.12191",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064, act="silu", rope_theta=1000000.0,
    mrope_sections=(16, 24, 24), n_patches=1024, d_patch=1280,
    fl_mapping="silo",
))

"""Gemma 2B [arXiv:2403.08295] — GeGLU, head_dim=256, MQA, tied embeddings."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-2b", family="dense", source="arXiv:2403.08295",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, act="geglu", tie_embeddings=True, emb_scale=True,
    rope_theta=10000.0, fl_mapping="cohort",
))

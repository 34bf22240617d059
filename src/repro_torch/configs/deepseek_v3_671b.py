"""DeepSeek-V3 671B [arXiv:2412.19437] — MLA, 1 shared + 256 routed top-8,
3 leading dense layers (d_ff 18432), MTP auxiliary head."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b", family="moe", source="arXiv:2412.19437",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280, act="silu", rope_theta=10000.0,
    n_experts=256, moe_top_k=8, n_shared_experts=1, d_expert=2048,
    n_dense_layers=3, d_ff_dense=18432, mtp=True, moe_impl="scatter",
    attn="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    fl_mapping="silo",
))

"""Run and model configuration: ``FLConfig`` and ``ModelConfig``, field for
field the ones in ``repro.configs.base`` (copied, not imported: the port
depends on nothing of ``repro``), and the registry keyed by ``--arch`` id.
The registry holds the paper's two CNNs (``configs.paper_cnn``); the other
model configs, and ``ModelConfig``'s parameter counts, come with the model
zoo (ROADMAP A13)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["ModelConfig", "FLConfig", "register", "get_config", "list_archs"]


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""  # citation for the config

    # trunk
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None  # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1000
    act: str = "silu"  # silu | geglu | gelu | sqrelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    emb_scale: bool = False  # gemma-style sqrt(d) embedding scaling
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    attn_logit_softcap: Optional[float] = None

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0  # per-expert ffn width
    n_dense_layers: int = 0  # leading dense layers (deepseek-v3 uses 3)
    d_ff_dense: int = 0  # ffn width of those dense layers
    router_aux_coef: float = 0.001  # load-balance loss coefficient
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"  # einsum (small E) | scatter (production scale)
    mtp: bool = False  # deepseek multi-token-prediction aux head

    # attention flavour
    attn: str = "gqa"  # gqa | mla
    q_lora_rank: int = 0  # MLA
    kv_lora_rank: int = 0  # MLA
    qk_nope_head_dim: int = 0  # MLA
    qk_rope_head_dim: int = 0  # MLA
    v_head_dim: int = 0  # MLA
    mla_absorb: bool = False  # absorbed-matmul decode (beyond-paper perf)

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv_width: int = 4
    ssm_ngroups: int = 1

    # hybrid (zamba2-style): shared attention block every N ssm layers
    hybrid_attn_every: int = 0

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_len: int = 1500  # stubbed conv-frontend output frames

    # vlm (qwen2-vl): stubbed patch embeddings
    n_patches: int = 0
    d_patch: int = 0

    # serving
    sliding_window: int = 0  # 0 = full attention; >0 enables SWA serving mode

    # numerics / distribution
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    fl_mapping: str = "cohort"  # cohort | silo


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning run config (paper Table I + selection scheme)."""

    K: int = 100  # total clients
    k: int = 20  # cohort size per round
    rounds: int = 400
    scheme: str = "e3cs"  # e3cs | random | fedcs | pow_d | ucb
    quota: str = "const"  # const | inc | linear | cosine
    quota_frac: float = 0.5  # sigma_t = frac * k/K for const
    eta: float = 0.5  # E3CS learning rate
    sampler: str = "plackett_luce"  # plackett_luce | systematic
    allocator: str = "sort"  # sort (paper case-analysis) | bisect (sort-free, shardable)
    pow_d: int = 40  # candidate-set size for pow-d
    # local update (o1)
    local_update: str = "fedavg"  # fedavg | fedprox
    prox_coef: float = 0.5
    local_epochs: Tuple[int, ...] = (1, 2, 3, 4)  # heterogeneous, sampled per client
    batch_size: int = 40
    lr: float = 1e-2
    momentum: float = 0.9
    # aggregation (o2)
    aggregation: str = "fedavg"  # fedavg (data-size weighted) | mean | epoch_weighted
    # async rounds: late-but-alive updates kept for S rounds, credited alpha**lag
    staleness_rounds: int = 0  # S: staleness buffer depth; 0 = sync deadline drop
    staleness_alpha: float = 0.5  # decay per round of lag
    late_prob: float = 0.7  # P(a missed-deadline client still completes)
    lag_decay: float = 0.5  # geometric lag tail: P(one more round) = 1 - lag_decay
    # volatility
    volatility: str = "bernoulli"  # builtin (bernoulli | markov | deadline) or a scenario name
    success_rates: Tuple[float, ...] = (0.1, 0.3, 0.6, 0.9)
    markov_stickiness: float = 0.8
    # data
    samples_per_client: int = 500
    non_iid: bool = True
    primary_frac: float = 0.8
    seed: int = 0


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    return sorted(_REGISTRY)

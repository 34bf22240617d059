"""Run and model configuration: ``FLConfig``, ``ModelConfig`` (with its
parameter counts), ``InputShape`` and ``smoke_variant``, the ones in
``repro.configs.base`` line for line (copied, not imported: the port depends
on nothing of ``repro``), and the registry keyed by ``--arch`` id."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

__all__ = [
    "ModelConfig",
    "FLConfig",
    "InputShape",
    "INPUT_SHAPES",
    "register",
    "get_config",
    "list_archs",
    "smoke_variant",
]


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

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def n_params(self) -> int:
        """Approximate parameter count (used for memory planning & 6ND)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm" or (self.family == "hybrid" and True):
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_headdim
            per = (
                d * (2 * d_in + 2 * self.ssm_ngroups * self.ssm_state + nheads)
                + d_in * d  # out proj
                + d_in * self.ssm_conv_width
                + 2 * nheads
            )
            ssm_total = per * L + emb
            if self.family == "ssm":
                return ssm_total
            # hybrid adds one shared attention+mlp block
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            mlp_mult = 3 if self.act in ("silu", "geglu") else 2
            return ssm_total + attn + mlp_mult * d * self.d_ff
        if self.attn == "mla":
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        else:
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        mlp_mult = 3 if self.act in ("silu", "geglu") else 2
        if self.family == "moe" and self.n_experts:
            n_moe = L - self.n_dense_layers
            moe = n_moe * (
                (self.n_experts + self.n_shared_experts) * mlp_mult * d * self.d_expert + d * self.n_experts
            )
            dense = self.n_dense_layers * mlp_mult * d * (self.d_ff_dense or self.d_ff)
            return emb + L * attn + moe + dense
        enc = 0
        if self.family == "encdec":
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            enc = self.n_enc_layers * (attn + mlp_mult * d * self.d_ff)
            dec = L * (2 * attn + mlp_mult * d * self.d_ff)
            return emb + enc + dec
        return emb + L * (attn + mlp_mult * d * self.d_ff)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        if self.family != "moe" or not self.n_experts:
            return self.n_params()
        mlp_mult = 3 if self.act in ("silu", "geglu") else 2
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = (
            d * self.q_lora_rank
            + self.q_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            + d * (self.kv_lora_rank + self.qk_rope_head_dim)
            + self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
            + self.n_heads * self.v_head_dim * d
            if self.attn == "mla"
            else d * self.resolved_head_dim * (self.n_heads + 2 * self.n_kv_heads)
            + self.n_heads * self.resolved_head_dim * d
        )
        n_moe = L - self.n_dense_layers
        active_moe = n_moe * ((self.moe_top_k + self.n_shared_experts) * mlp_mult * d * self.d_expert)
        dense = self.n_dense_layers * mlp_mult * d * (self.d_ff_dense or self.d_ff)
        return emb + L * attn + active_moe + dense


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


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


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


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts."""
    d = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    hd = 64
    kv = max(1, min(cfg.n_kv_heads, n_heads))
    # keep the GQA/MQA character: preserve heads-per-kv ratio where possible
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    kv = max(1, n_heads // ratio)
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=d,
        n_heads=n_heads,
        n_kv_heads=kv,
        head_dim=hd,
        d_ff=min(cfg.d_ff, 512) or 512,
        vocab=min(cfg.vocab, 512),
        remat=False,
        dtype="float32",
        param_dtype="float32",
        fl_mapping="cohort",
    )
    if cfg.family == "moe":
        kw.update(
            n_experts=min(cfg.n_experts, 4),
            moe_top_k=min(cfg.moe_top_k, 2),
            d_expert=min(cfg.d_expert, 128) or 128,
            n_dense_layers=min(cfg.n_dense_layers, 1),
            d_ff_dense=min(cfg.d_ff_dense, 256) if cfg.d_ff_dense else 0,
        )
    if cfg.attn == "mla":
        kw.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=min(cfg.ssm_state, 16) or 16, ssm_headdim=32, ssm_chunk=32)
        if cfg.family == "hybrid":
            kw.update(n_layers=4, hybrid_attn_every=2)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, enc_len=64)
    if cfg.family == "vlm":
        kw.update(n_patches=16, d_patch=64)
        if cfg.mrope_sections is not None:
            # scale M-RoPE sections to the reduced head_dim (sum*2 == hd)
            kw.update(mrope_sections=(8, 12, 12))
    if cfg.sliding_window:
        kw.update(sliding_window=min(cfg.sliding_window, 64))
    return replace(cfg, **kw)

"""DeepSeek-V2/V3 Multi-head Latent Attention (MLA), the port of
``repro.models.mla``.

Projections (per arXiv:2412.19437 §2.1.1):
    c_q  = W_dq x                (q_lora_rank)            -> norm
    q    = W_uq c_q              (H, qk_nope + qk_rope)   rope on the rope part
    c_kv = W_dkv x               (kv_lora_rank)           -> norm, **cached**
    k_r  = W_kr x                (qk_rope_head_dim)       rope, shared across heads, **cached**
    k    = [W_uk c_kv ; k_r]     (H, qk_nope + qk_rope)
    v    = W_uv c_kv             (H, v_head_dim)
    out  = W_o (attn @ v)

The decode cache stores only ``(c_kv, k_r)``.  ``mla_absorb=True`` folds
``W_uk`` into the query and ``W_uv`` into the output projection, so scores
and values are computed in the latent space.  ``MLACache.pos`` is a host
``int`` and ``mla_decode`` writes into the cache in place, as
``attention.attn_decode`` does (a token past the end of a cache without a
window raises ``ValueError``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .attention import NEG_FILL, decode_slot, valid_slots
from .layers import ParamBuilder, apply_rope, rmsnorm
from .sharding import einsum, shard, write_slot

__all__ = ["MLACache", "mla_init", "mla_apply", "mla_decode", "init_mla_cache"]


class MLACache(NamedTuple):
    c_kv: torch.Tensor  # (B, S, kv_lora_rank)
    k_rope: torch.Tensor  # (B, S, qk_rope_head_dim)
    pos: int


def mla_init(pb: ParamBuilder, cfg):
    d, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    pb.p("w_dq", (d, qr), ("embed", "lora"), fan_in=d)
    pb.p("q_norm", (qr,), ("lora",), init="ones")
    pb.p("w_uq", (qr, H, dn + dr), ("lora", "q_heads", "head_dim"), fan_in=qr)
    pb.p("w_dkv", (d, kvr), ("embed", "lora"), fan_in=d)
    pb.p("kv_norm", (kvr,), ("lora",), init="ones")
    pb.p("w_kr", (d, dr), ("embed", "head_dim"), fan_in=d)
    pb.p("w_uk", (kvr, H, dn), ("lora", "q_heads", "head_dim"), fan_in=kvr)
    pb.p("w_uv", (kvr, H, dv), ("lora", "q_heads", "head_dim"), fan_in=kvr)
    pb.p("wo", (H, dv, d), ("q_heads", "head_dim", "embed"), fan_in=H * dv)


def _scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _latents(p, x, cfg, positions):
    """Compute (q_nope, q_rope, c_kv, k_rope) with rope applied."""
    dn = cfg.qk_nope_head_dim
    c_q = rmsnorm(einsum("bsd,dr->bsr", x, p["w_dq"]), p["q_norm"], cfg.norm_eps)
    q = einsum("bsr,rhk->bshk", c_q, p["w_uq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    c_kv = rmsnorm(einsum("bsd,dr->bsr", x, p["w_dkv"]), p["kv_norm"], cfg.norm_eps)
    k_rope = einsum("bsd,dk->bsk", x, p["w_kr"])
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(p, q_nope, q_rope, c_kv, k_rope, cfg, mask, absorb: bool):
    """Score+combine. q_*: (B,S,H,*), c_kv: (B,T,r), k_rope: (B,T,dr)."""
    if absorb:
        # fold W_uk into q: q_lat (B,S,H,r); scores vs latent cache directly
        q_lat = einsum("bshn,rhn->bshr", q_nope, p["w_uk"])
        s_nope = einsum("bshr,btr->bhst", q_lat, c_kv)
    else:
        k_nope = einsum("btr,rhn->bthn", c_kv, p["w_uk"])
        s_nope = einsum("bshn,bthn->bhst", q_nope, k_nope)
    s_rope = einsum("bshk,btk->bhst", q_rope, k_rope)
    scores = (s_nope + s_rope).to(torch.float32) * _scale(cfg)
    scores = torch.where(mask, scores, NEG_FILL)
    w = torch.softmax(scores, dim=-1).to(c_kv.dtype)
    if absorb:
        o_lat = einsum("bhst,btr->bshr", w, c_kv)
        out = einsum("bshr,rhv->bshv", o_lat, p["w_uv"])
    else:
        v = einsum("btr,rhv->bthv", c_kv, p["w_uv"])
        out = einsum("bhst,bthv->bshv", w, v)
    return einsum("bshv,hvd->bsd", out, p["wo"])


def _mla_attend_chunked(p, q_nope, q_rope, c_kv, k_rope, cfg, window: int, chunk_q: int = 512, chunk_k: int = 1024):
    """Memory-efficient MLA prefill: running softmax over latent-KV chunks,
    always in the absorbed form (the reference scans; the carry is the same)."""
    B, S, H, dn = q_nope.shape
    T = c_kv.shape[1]
    r = c_kv.shape[-1]
    cq = min(chunk_q, S)
    ck = min(chunk_k, T)
    assert S % cq == 0 and T % ck == 0
    nq, nk = S // cq, T // ck
    scale = _scale(cfg)
    dev = q_nope.device
    q_lat = einsum("bshn,rhn->bshr", q_nope, p["w_uk"])  # (B,S,H,r)
    qlc = q_lat.reshape(B, nq, cq, H, r)
    qrc = q_rope.reshape(B, nq, cq, H, -1)
    ckv = c_kv.reshape(B, nk, ck, r)
    krc = k_rope.reshape(B, nk, ck, -1)
    ar_q = torch.arange(cq, device=dev)[:, None]
    ar_k = torch.arange(ck, device=dev)[None, :]
    outs = []
    for qi in range(nq):
        ql, qr = qlc[:, qi], qrc[:, qi]
        m = torch.full((B, H, cq), NEG_FILL, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, cq, r), dtype=torch.float32, device=dev)
        for kj in range(nk):
            cb, krb = ckv[:, kj], krc[:, kj]
            s = (einsum("bqhr,btr->bhqt", ql, cb) + einsum("bqhk,btk->bhqt", qr, krb)).to(
                torch.float32) * scale
            q_pos = qi * cq + ar_q
            k_pos = kj * ck + ar_k
            mask = k_pos <= q_pos
            if window > 0:
                mask &= k_pos > q_pos - window
            s = torch.where(mask, s, NEG_FILL)
            m_new = torch.maximum(m, s.amax(-1))
            pr = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + pr.sum(-1)
            acc = acc * alpha[..., None] + einsum("bhqt,btr->bhqr", pr.to(cb.dtype), cb).to(torch.float32)
            m = m_new
        o_lat = (acc / torch.where(l == 0, 1.0, l)[..., None]).to(c_kv.dtype)  # (B,H,cq,r)
        outs.append(einsum("bhqr,rhv->bqhv", o_lat, p["w_uv"]))  # (B,cq,H,dv)
    out = torch.cat(outs, dim=1)
    return einsum("bshv,hvd->bsd", out, p["wo"])


def mla_apply(p, x, cfg, positions, mode: str = "train", window: int = 0, impl: str = "einsum"):
    B, S, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _latents(p, x, cfg, positions)
    c_kv = shard(c_kv, "batch", "seq", None)
    if impl == "chunked":
        y = _mla_attend_chunked(p, q_nope, q_rope, c_kv, k_rope, cfg, window)
    else:
        qi = torch.arange(S, device=x.device)[:, None]
        kj = torch.arange(S, device=x.device)[None, :]
        mask = kj <= qi
        if window > 0:
            mask &= kj > qi - window
        y = _mla_attend(p, q_nope, q_rope, c_kv, k_rope, cfg, mask[None, None], cfg.mla_absorb)
    cache = None
    if mode == "prefill":
        if window > 0:
            keep = min(window, S)
            ck, kr = (torch.cat([t[:, S - keep:], torch.zeros((B, window - keep, t.shape[-1]), dtype=t.dtype,
                                                              device=x.device)], dim=1) for t in (c_kv, k_rope))
            cache = MLACache(ck, kr, S)
        else:
            cache = MLACache(c_kv, k_rope, S)
    return y, cache


def init_mla_cache(cfg, B: int, S_cache: int, window: int = 0, dtype=torch.bfloat16, device=None) -> MLACache:
    n = min(window, S_cache) if window > 0 else S_cache
    return MLACache(
        torch.zeros((B, n, cfg.kv_lora_rank), dtype=dtype, device=device),
        torch.zeros((B, n, cfg.qk_rope_head_dim), dtype=dtype, device=device),
        0,
    )


def mla_decode(p, x, cfg, cache: MLACache, window: int = 0):
    """One-token step. x: (B, 1, d). The new latents are written into
    ``cache``'s buffers."""
    B = x.shape[0]
    pos = cache.pos
    n_slots = cache.c_kv.shape[1]
    slot = decode_slot(pos, n_slots, window)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _latents(p, x, cfg, positions)
    write_slot(cache.c_kv, slot, c_kv[:, 0].to(cache.c_kv.dtype))
    write_slot(cache.k_rope, slot, k_rope[:, 0].to(cache.k_rope.dtype))
    ck = shard(cache.c_kv, "batch", "cache_seq", None)
    mask = valid_slots(pos, slot, n_slots, window, x.device)[None, None, None, :]
    y = _mla_attend(p, q_nope, q_rope, ck, cache.k_rope, cfg, mask, cfg.mla_absorb)
    return y, MLACache(cache.c_kv, cache.k_rope, pos + 1)

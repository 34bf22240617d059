"""GQA/MQA/MHA attention with RoPE / M-RoPE, sliding window and KV cache,
the port of ``repro.models.attention``.

Three entry points share one score/softmax core:
  * ``attn_apply(..., mode="train")``   — full-sequence causal.
  * ``attn_apply(..., mode="prefill")`` — causal + returns the filled cache.
  * ``attn_decode``                     — one new token against a cache.

A ``window > 0`` enables sliding-window attention; in decode mode the cache
is a ring buffer of ``window`` slots.  ``impl="chunked"`` swaps in the
running-softmax blocked path for long train/prefill sequences.

The core keeps the reference's math: GQA grouping by reshape, float32
scores, the logit softcap and a fill of ``-1e30`` for masked scores.

Decode state.  ``KVCache.pos`` is a host ``int``: decode is driven from the
host, so the slot a token goes to is known without a device sync.
``attn_decode`` writes the new key and value into the cache's buffers in
place and returns them with ``pos + 1`` (the reference returns new arrays;
a caller that needs the old cache copies it first).  On a cache without a
window, a token past its last slot raises ``ValueError`` (the reference drops
that write silently).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .layers import ParamBuilder, apply_mrope, apply_rope
from .sharding import einsum, shard, splits_evenly, write_slot

__all__ = ["attn_init", "attn_apply", "attn_decode", "init_kv_cache", "KVCache"]

NEG_FILL = -1e30  # the reference's fill for masked scores


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_cache, KV, hd)
    v: torch.Tensor  # (B, S_cache, KV, hd)
    pos: int  # number of tokens already absorbed


def attn_init(pb: ParamBuilder, cfg):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    pb.p("wq", (d, H, hd), ("embed", "q_heads", "head_dim"), fan_in=d)
    pb.p("wk", (d, KV, hd), ("embed", "kv_heads", "head_dim"), fan_in=d)
    pb.p("wv", (d, KV, hd), ("embed", "kv_heads", "head_dim"), fan_in=d)
    pb.p("wo", (H, hd, d), ("q_heads", "head_dim", "embed"), fan_in=H * hd)


def _project_qkv(p, x, cfg, positions):
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mesh_heads(q, k, v):
    """``(k, v)``, each KV head repeated for its G query heads where the
    query heads' shards on a mesh straddle the KV groups (e.g. 128 heads
    over 16 ranks against 8 KV heads), so the grouped reshape below keeps
    them whole; otherwise as given (always on one device)."""
    H, KV = q.shape[2], k.shape[2]
    if splits_evenly(q, 2, KV):
        return k, v
    B, T, _, hd = k.shape
    return tuple(t[:, :, :, None, :].expand(B, T, KV, H // KV, hd).reshape(B, T, H, hd) for t in (k, v))


def _sdpa(q, k, v, mask, softcap: Optional[float]):
    """q: (B,S,H,hd), k/v: (B,T,KV,hd) with H = G*KV.  mask: (B,1,S,T) bool
    (or any shape that broadcasts against the (B,KV,G,S,T) scores)."""
    B, S, H, hd = q.shape
    k, v = _mesh_heads(q, k, v)
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    scores = einsum("bskgh,btkh->bkgst", qg, k).to(torch.float32) / math.sqrt(hd)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(mask[:, :, None] if mask.dim() == 4 else mask, scores, NEG_FILL)
    w = torch.softmax(scores, dim=-1)
    out = einsum("bkgst,btkh->bskgh", w.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def _chunked_sdpa(q, k, v, causal: bool, window: int, softcap, chunk_q: int = 512, chunk_k: int = 1024):
    """Memory-efficient attention: a loop over (q-chunk, kv-chunk) pairs with
    a running-softmax carry (the reference scans; the carry and its order are
    the same), for long prefill where the (S, T) scores would not fit.

    q: (B,S,H,hd); k/v: (B,T,KV,hd).
    """
    B, S, H, hd = q.shape
    k, v = _mesh_heads(q, k, v)
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    cq = min(chunk_q, S)
    ck = min(chunk_k, T)
    assert S % cq == 0 and T % ck == 0, (S, cq, T, ck)
    nq, nk = S // cq, T // ck
    scale = 1.0 / math.sqrt(hd)
    qc = q.reshape(B, nq, cq, KV, G, hd)
    kc = k.reshape(B, nk, ck, KV, hd)
    vc = v.reshape(B, nk, ck, KV, hd)
    ar_q = torch.arange(cq, device=q.device)[:, None]
    ar_k = torch.arange(ck, device=q.device)[None, :]
    outs = []
    for qi in range(nq):
        qb = qc[:, qi]  # (B, cq, KV, G, hd)
        m = torch.full((B, KV, G, cq), NEG_FILL, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, G, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, cq, hd), dtype=torch.float32, device=q.device)
        for kj in range(nk):
            kb, vb = kc[:, kj], vc[:, kj]
            s = einsum("bqkgh,btkh->bkgqt", qb, kb).to(torch.float32) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            q_pos = qi * cq + ar_q
            k_pos = kj * ck + ar_k
            mask = torch.ones((cq, ck), dtype=torch.bool, device=q.device)
            if causal:
                mask &= k_pos <= q_pos
            if window > 0:
                mask &= k_pos > q_pos - window
            s = torch.where(mask, s, NEG_FILL)
            m_new = torch.maximum(m, s.amax(-1))
            pr = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + pr.sum(-1)
            acc = acc * alpha[..., None] + einsum("bkgqt,btkh->bkgqh", pr.to(vb.dtype), vb).to(torch.float32)
            m = m_new
        out = acc / torch.where(l == 0, 1.0, l)[..., None]
        outs.append(torch.movedim(out, 3, 1).reshape(B, cq, KV * G, hd).to(q.dtype))  # (B,cq,H,hd)
    return torch.cat(outs, dim=1)


def _causal_mask(S: int, T: int, offset: int, window: int, device=None) -> torch.Tensor:
    """(S, T) bool; query i attends key j iff j <= i+offset and within window."""
    qi = torch.arange(S, device=device)[:, None] + offset
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= kj > qi - window
    return m


def attn_apply(
    p,
    x: torch.Tensor,
    cfg,
    positions: Optional[torch.Tensor],
    mode: str = "train",
    window: int = 0,
    impl: str = "einsum",
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Full-sequence attention. Returns (out, cache|None)."""
    B, S, _ = x.shape
    if cross_kv is not None:
        q = einsum("bsd,dhk->bshk", x, p["wq"])
        k, v = cross_kv
        mask = torch.ones((B, 1, S, k.shape[1]), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask, cfg.attn_logit_softcap)
    else:
        q, k, v = _project_qkv(p, x, cfg, positions)
        k = shard(k, "batch", "seq", "kv_heads", "head_dim")
        v = shard(v, "batch", "seq", "kv_heads", "head_dim")
        if impl == "chunked":
            out = _chunked_sdpa(q, k, v, True, window, cfg.attn_logit_softcap)
        else:
            mask = _causal_mask(S, S, 0, window, x.device)[None, None]
            out = _sdpa(q, k, v, mask, cfg.attn_logit_softcap)
    out = shard(out, "batch", "seq", "q_heads", "head_dim")
    y = einsum("bshk,hkd->bsd", out, p["wo"])
    cache = None
    if mode == "prefill" and cross_kv is None:
        if window > 0:
            # the trailing `window` keys at slots 0..keep-1, oldest first (the
            # reference's layout; its decode then writes slot pos % window)
            keep = min(window, S)
            kw, vw = (torch.cat([t[:, S - keep:], torch.zeros((B, window - keep, *t.shape[2:]), dtype=t.dtype,
                                                              device=t.device)], dim=1) for t in (k, v))
            cache = KVCache(kw, vw, S)
        else:
            cache = KVCache(k, v, S)
    return y, cache


def init_kv_cache(cfg, B: int, S_cache: int, window: int = 0, dtype=torch.bfloat16, device=None) -> KVCache:
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    n = min(window, S_cache) if window > 0 else S_cache
    shape = (B, n, KV, hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device), 0)


def decode_slot(pos: int, n_slots: int, window: int) -> int:
    """The cache slot of the token at ``pos``: ``pos % n_slots`` on a ring
    (window > 0), else ``pos``, which must lie inside the cache."""
    if window > 0:
        return pos % n_slots
    if pos >= n_slots:
        raise ValueError(f"decode past the cache: token {pos} into a cache of {n_slots} slots "
                         "(prefill with a larger max_len, or serve with a window)")
    return pos


def valid_slots(pos: int, slot: int, n_slots: int, window: int, device) -> torch.Tensor:
    """(n_slots,) bool: the slots a decode step at ``pos`` attends."""
    slots = torch.arange(n_slots, device=device)
    if window > 0 and pos >= n_slots:  # ring: all valid once wrapped
        return torch.ones(n_slots, dtype=torch.bool, device=device)
    return slots <= (slot if window > 0 else pos)


def attn_decode(
    p,
    x: torch.Tensor,
    cfg,
    cache: Optional[KVCache],
    window: int = 0,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    positions: Optional[torch.Tensor] = None,
):
    """One-token step. x: (B, 1, d). Returns (out, new_cache): the new key and
    value are written into ``cache``'s buffers."""
    B = x.shape[0]
    if cross_kv is not None:
        q = einsum("bsd,dhk->bshk", x, p["wq"])
        k, v = cross_kv
        mask = torch.ones((B, 1, 1, k.shape[1]), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask, cfg.attn_logit_softcap)
        return einsum("bshk,hkd->bsd", out, p["wo"]), cache

    pos = cache.pos  # number of tokens already in context
    if positions is None:
        shape = (3, B, 1) if cfg.mrope_sections is not None else (B, 1)
        positions = torch.full(shape, pos, dtype=torch.int64, device=x.device)
    n_slots = cache.k.shape[1]
    slot = decode_slot(pos, n_slots, window)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    write_slot(cache.k, slot, k_new[:, 0].to(cache.k.dtype))
    write_slot(cache.v, slot, v_new[:, 0].to(cache.v.dtype))
    k = shard(cache.k, "batch", "cache_seq", "kv_heads", "head_dim")
    v = shard(cache.v, "batch", "cache_seq", "kv_heads", "head_dim")
    mask = valid_slots(pos, slot, n_slots, window, x.device)[None, None, None, :]
    out = _sdpa(q, k, v, mask, cfg.attn_logit_softcap)
    y = einsum("bshk,hkd->bsd", out, p["wo"])
    return y, KVCache(cache.k, cache.v, pos + 1)

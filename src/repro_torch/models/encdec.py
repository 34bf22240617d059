"""Whisper-style encoder-decoder (arXiv:2212.04356), the port of
``repro.models.encdec``.

The mel-spectrogram + conv frontend is stubbed: the model consumes
precomputed frame embeddings ``frames: (B, enc_len, d_model)``.  Absolute
sinusoidal positions on the encoder, learned positions on the decoder
(``_MAX_DEC_POS`` of them), LayerNorm + GELU as in the original.  Decode
takes per-layer cross-attention K/V computed from the encoder output once
and carries a self-attention cache (``pos`` a host ``int``, written in place
as ``attention.attn_decode`` writes).
"""
from __future__ import annotations

import torch

from . import attention as attn_mod
from .layers import ParamBuilder, mlp_apply, mlp_init, norm_apply, norm_init, sinusoidal_positions
from .remat import remat
from .sharding import einsum, lookup, shard
from .transformer import _layer, _stacked, depth, torch_dtype, unstack

__all__ = ["encdec_init", "encdec_forward", "encdec_encode", "encdec_decode_step", "encdec_init_caches"]

_MAX_DEC_POS = 65536  # learned decoder positions table (sized for the 32k serving shapes)


def _enc_block_init(pb: ParamBuilder, cfg):
    norm_init(pb, "norm1", cfg.d_model, cfg.norm)
    attn_mod.attn_init(pb.child("attn"), cfg)
    norm_init(pb, "norm2", cfg.d_model, cfg.norm)
    mlp_init(pb.child("ffn"), cfg.d_model, cfg.d_ff, cfg.act)


def _dec_block_init(pb: ParamBuilder, cfg):
    norm_init(pb, "norm1", cfg.d_model, cfg.norm)
    attn_mod.attn_init(pb.child("self_attn"), cfg)
    norm_init(pb, "norm_x", cfg.d_model, cfg.norm)
    attn_mod.attn_init(pb.child("cross_attn"), cfg)
    norm_init(pb, "norm2", cfg.d_model, cfg.norm)
    mlp_init(pb.child("ffn"), cfg.d_model, cfg.d_ff, cfg.act)


def encdec_init(rng, cfg, device=None):
    """``(params, specs)`` drawn from ``rng`` (a ``core.prng.Key``: the
    reference's values, the encoder's stack under ``fold_in(rng, 1)`` and
    the decoder's under ``fold_in(rng, 2)``) onto ``device`` (the key's
    unless given; ``"meta"`` allocates nothing)."""
    pb = ParamBuilder(rng, torch_dtype(cfg.param_dtype), device)
    pb.p("tok_emb", (cfg.vocab, cfg.d_model), ("vocab", "embed"), init="embed")
    pb.p("dec_pos", (_MAX_DEC_POS, cfg.d_model), (None, "embed"), init="embed")
    norm_init(pb, "enc_final", cfg.d_model, cfg.norm)
    norm_init(pb, "dec_final", cfg.d_model, cfg.norm)
    _enc_block_init(pb.child("enc", stack=cfg.n_enc_layers, fold=1), cfg)
    _dec_block_init(pb.child("dec", stack=cfg.n_layers, fold=2), cfg)
    return pb.params, pb.specs


def _enc_layer(cfg):
    """One encoder layer as ``body(x, p, full) -> (x,)``, ``full`` its
    attention mask."""

    def body(x, p, full):
        h = norm_apply(p, "norm1", x, cfg.norm, cfg.norm_eps)
        # bidirectional: no positions (sinusoidal already added), full mask
        q = einsum("bsd,dhk->bshk", h, p["attn"]["wq"])
        k = einsum("bsd,dhk->bshk", h, p["attn"]["wk"])
        v = einsum("bsd,dhk->bshk", h, p["attn"]["wv"])
        o = attn_mod._sdpa(q, k, v, full, None)
        x = x + einsum("bshk,hkd->bsd", o, p["attn"]["wo"])
        h = norm_apply(p, "norm2", x, cfg.norm, cfg.norm_eps)
        return (x + mlp_apply(p["ffn"], h, cfg.act),)

    return body


def encdec_encode(params, cfg, frames):
    """frames: (B, enc_len, d_model) stub embeddings -> encoder output.
    Each layer runs through ``remat`` where ``cfg.remat`` holds (the plain
    layer under no gradient)."""
    B, S, d = frames.shape
    dt = torch_dtype(cfg.dtype)
    x = frames.to(dt) + sinusoidal_positions(S, d, frames.device).to(dt)[None]
    x = shard(x, "batch", "enc_seq", "embed")
    full = torch.ones((B, 1, S, S), dtype=torch.bool, device=frames.device)
    body = _enc_layer(cfg)
    for p in unstack(params["enc"]):
        (x,) = remat(body, x, p, full) if cfg.remat else body(x, p, full)
    return norm_apply(params, "enc_final", x, cfg.norm, cfg.norm_eps)


def _cross_kv(p_dec, cfg, enc_out):
    """Per-layer cross K/V from the encoder output: a (L, B, T, KV, hd) pair."""
    k = einsum("btd,ldhk->lbthk", enc_out, p_dec["cross_attn"]["wk"])
    v = einsum("btd,ldhk->lbthk", enc_out, p_dec["cross_attn"]["wv"])
    return k, v


def _dec_layer(cfg, mode, window):
    """One decoder layer as ``body(x, p, xk, xv) -> (x, self-attention
    cache)``, ``(xk, xv)`` its cross K/V."""

    def body(x, p, xk, xv):
        h = norm_apply(p, "norm1", x, cfg.norm, cfg.norm_eps)
        y, cache = attn_mod.attn_apply(p["self_attn"], h, cfg, None, mode, window)
        x = x + y
        h = norm_apply(p, "norm_x", x, cfg.norm, cfg.norm_eps)
        y, _ = attn_mod.attn_apply(p["cross_attn"], h, cfg, None, "train", 0, cross_kv=(xk, xv))
        x = x + y
        h = norm_apply(p, "norm2", x, cfg.norm, cfg.norm_eps)
        return x + mlp_apply(p["ffn"], h, cfg.act), cache

    return body


def encdec_forward(params, cfg, batch, mode: str = "train", window: int = 0):
    """Teacher-forced decoder over (B, S) tokens; returns (logits, caches,
    aux).  Each decoder layer runs through ``remat`` where ``cfg.remat``
    holds and ``mode == "train"``."""
    enc_out = encdec_encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = (lookup(params["tok_emb"], tokens) + params["dec_pos"][:S][None]).to(torch_dtype(cfg.dtype))
    x = shard(x, "batch", "seq", "embed")
    xk, xv = _cross_kv(params["dec"], cfg, enc_out)
    body = _dec_layer(cfg, mode, window)
    caches = []
    for p, k, v in zip(unstack(params["dec"]), xk.unbind(0), xv.unbind(0)):
        if cfg.remat and mode == "train":
            x, cache = remat(lambda *a: body(*a)[:1], x, p, k, v)[0], None
        else:
            x, cache = body(x, p, k, v)
        caches.append(cache)
    x = norm_apply(params, "dec_final", x, cfg.norm, cfg.norm_eps)
    logits = einsum("bsd,vd->bsv", x, params["tok_emb"])
    logits = shard(logits, "batch", "seq", "vocab")
    out_caches = None
    if mode == "prefill":
        self_c = attn_mod.KVCache(torch.stack([c.k for c in caches]), torch.stack([c.v for c in caches]), caches[0].pos)
        out_caches = {"self": self_c, "cross": (xk, xv)}
    return logits, out_caches, (torch.zeros((), dtype=torch.float32, device=x.device), None)


def encdec_init_caches(cfg, B: int, S_cache: int, window: int = 0, dtype=torch.bfloat16, device=None):
    self_c = _stacked(attn_mod.init_kv_cache(cfg, B, S_cache, window, dtype, device), cfg.n_layers)
    shape = (cfg.n_layers, B, cfg.enc_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"self": self_c, "cross": tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(2))}


def encdec_decode_step(params, cfg, tokens, caches, window: int = 0):
    """tokens: (B,1). caches: {'self': stacked KVCache, 'cross': (L,B,T,KV,hd)x2};
    the self-attention cache is written in place and returned with ``pos + 1``."""
    self_c = caches["self"]
    pos = self_c.pos
    x = (lookup(params["tok_emb"], tokens) + params["dec_pos"][pos][None, None]).to(torch_dtype(cfg.dtype))
    xk, xv = caches["cross"]
    for i in range(depth(params["dec"])):
        p = _layer(params["dec"], i)
        h = norm_apply(p, "norm1", x, cfg.norm, cfg.norm_eps)
        y, _ = attn_mod.attn_decode(p["self_attn"], h, cfg, _layer(self_c, i), window)
        x = x + y
        h = norm_apply(p, "norm_x", x, cfg.norm, cfg.norm_eps)
        y, _ = attn_mod.attn_decode(p["cross_attn"], h, cfg, None, 0, cross_kv=(xk[i], xv[i]))
        x = x + y
        h = norm_apply(p, "norm2", x, cfg.norm, cfg.norm_eps)
        x = x + mlp_apply(p["ffn"], h, cfg.act)
    x = norm_apply(params, "dec_final", x, cfg.norm, cfg.norm_eps)
    logits = einsum("bsd,vd->bsv", x, params["tok_emb"])
    return logits, {"self": attn_mod.KVCache(self_c.k, self_c.v, pos + 1), "cross": caches["cross"]}

"""Composable decoder-only stack covering dense / moe / ssm / hybrid / vlm,
the port of ``repro.models.transformer``.

Layers are grouped into *segments* of identical block kind (e.g. DeepSeek-V3 =
3x ``mla_mlp`` + 58x ``mla_moe``); each segment's parameters are stacked along
a leading ``layers`` axis, as the reference stacks them, and a segment runs as
a Python loop over its layers' views (the reference's ``scan_layers=False``
branch; its ``lax.scan`` computes the same).  Zamba2-style hybrids apply a
weight-shared attention block after every ``hybrid_attn_every``-th SSM layer
(per-site KV caches): the reference's ``lax.cond`` is an ``if`` on the layer
index here.  Where ``cfg.remat`` holds and ``mode == "train"``, each layer
(with the hybrid's shared attention at its site, the unit the reference
checkpoints) runs through ``remat.remat``: under a gradient its activations
are recomputed in the backward; under no gradient it is the plain layer, so
the serving path (prefill, decode, a ``forward`` without grad) is untouched.

Entry points:
  * ``model_init(rng, cfg, device)``              -> (params, specs)
  * ``forward(params, cfg, batch, mode)``         -> logits, caches, (aux, mtp_logits)
  * ``decode_step(params, cfg, tokens, caches)``  -> logits, caches
  * ``init_caches(cfg, B, S_cache, window)``      -> cache dict

A cache's ``pos`` is a host ``int``, one for a whole stacked segment.  Decode
writes each layer's new entries into the stacked buffers in place
(``attention.attn_decode``) and returns the same buffers with ``pos + 1``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree

from . import attention as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import ParamBuilder, mlp_apply, mlp_init, norm_apply, norm_init
from .remat import remat
from .sharding import einsum, lookup, shard

__all__ = ["segments_of", "model_init", "forward", "decode_step", "init_caches", "pad_caches", "cache_specs",
           "vlm_positions"]


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# --------------------------------------------------------------- segments --


def segments_of(cfg) -> List[Tuple[str, int]]:
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return [("attn_mlp", cfg.n_layers)]
    if fam == "moe":
        a = "mla" if cfg.attn == "mla" else "attn"
        segs = []
        if cfg.n_dense_layers:
            segs.append((f"{a}_mlp", cfg.n_dense_layers))
        segs.append((f"{a}_moe", cfg.n_layers - cfg.n_dense_layers))
        return segs
    if fam == "ssm":
        return [("ssm", cfg.n_layers)]
    if fam == "hybrid":
        return [("ssm", cfg.n_layers)]  # shared attn handled separately
    raise ValueError(fam)


def _block_init(pb: ParamBuilder, cfg, kind: str):
    if kind == "ssm":
        norm_init(pb, "norm1", cfg.d_model, cfg.norm)
        ssm_mod.ssm_init(pb.child("ssm"), cfg)
        return
    attn_kind, ffn_kind = kind.split("_")
    norm_init(pb, "norm1", cfg.d_model, cfg.norm)
    if attn_kind == "mla":
        mla_mod.mla_init(pb.child("attn"), cfg)
    else:
        attn_mod.attn_init(pb.child("attn"), cfg)
    norm_init(pb, "norm2", cfg.d_model, cfg.norm)
    if ffn_kind == "moe":
        moe_mod.moe_init(pb.child("ffn"), cfg)
    else:
        d_ff = cfg.d_ff_dense if (cfg.family == "moe" and cfg.d_ff_dense) else cfg.d_ff
        mlp_init(pb.child("ffn"), cfg.d_model, d_ff, cfg.act)


def _stack_init(pb: ParamBuilder, name: str, cfg, kind: str, n: int, fold: int):
    """Segment ``name``: ``n`` blocks of ``kind``, each parameter stacked
    along a leading ``layers`` axis and drawn a layer at a time, under
    ``fold_in(rng, fold)``."""
    _block_init(pb.child(name, stack=n, fold=fold), cfg, kind)


# ---------------------------------------------------------------- blocks ---


def _block_apply(p, x, cfg, kind: str, positions, mode: str, window: int, cache, impl: str):
    """Returns (x, new_cache, aux); aux is None for a block without MoE."""
    h = norm_apply(p, "norm1", x, cfg.norm, cfg.norm_eps, plus_one=cfg.emb_scale)
    if kind == "ssm":
        if mode == "decode":
            y, cache = ssm_mod.ssm_decode(p["ssm"], h, cfg, cache)
        else:
            y, cache = ssm_mod.ssm_apply(p["ssm"], h, cfg, mode, impl)
        return x + y, cache, None
    attn_kind, ffn_kind = kind.split("_")
    if attn_kind == "mla":
        if mode == "decode":
            y, cache = mla_mod.mla_decode(p["attn"], h, cfg, cache, window)
        else:
            y, cache = mla_mod.mla_apply(p["attn"], h, cfg, positions, mode, window, impl)
    else:
        if mode == "decode":
            y, cache = attn_mod.attn_decode(p["attn"], h, cfg, cache, window)
        else:
            y, cache = attn_mod.attn_apply(p["attn"], h, cfg, positions, mode, window, impl)
    x = x + y
    h = norm_apply(p, "norm2", x, cfg.norm, cfg.norm_eps, plus_one=cfg.emb_scale)
    aux = None
    if ffn_kind == "moe":
        y, aux = moe_mod.moe_apply(p["ffn"], h, cfg)
    else:
        y = mlp_apply(p["ffn"], h, cfg.act)
    return x + y, cache, aux


# ---------------------------------------------------------------- model ----


def model_init(rng, cfg, device=None):
    """``(params, specs)``: the reference's tree (names, nesting, shapes,
    dtypes and logical axes), drawn from ``rng`` (a ``core.prng.Key``: the
    reference's values; see ``layers.ParamBuilder``) onto ``device`` (the
    key's unless given; ``"meta"`` allocates nothing)."""
    pb = ParamBuilder(rng, torch_dtype(cfg.param_dtype), device)
    pb.p("tok_emb", (cfg.vocab, cfg.d_model), ("vocab", "embed"), init="embed")
    if not cfg.tie_embeddings:
        pb.p("out_head", (cfg.d_model, cfg.vocab), ("embed", "vocab"), fan_in=cfg.d_model)
    norm_init(pb, "final_norm", cfg.d_model, cfg.norm)
    if cfg.family == "vlm":
        pb.p("patch_proj", (cfg.d_patch, cfg.d_model), ("patch", "embed"), fan_in=cfg.d_patch)
    if cfg.mtp:
        pb.p("mtp_proj", (2 * cfg.d_model, cfg.d_model), (None, "embed"), fan_in=2 * cfg.d_model)
        norm_init(pb, "mtp_norm", cfg.d_model, cfg.norm)
    for si, (kind, n) in enumerate(segments_of(cfg)):
        _stack_init(pb, f"seg{si}", cfg, kind, n, fold=1000 + si)
    if cfg.family == "hybrid":
        spb = pb.child("shared_attn", fold=777)
        _block_init(spb, cfg, "attn_mlp")
        wpb = pb.child(None, fold=778)
        wpb.p("w_concat", (2 * cfg.d_model, cfg.d_model), (None, "embed"), fan_in=2 * cfg.d_model)
        spb.params.update(wpb.params)
        spb.specs.update(wpb.specs)
    return pb.params, pb.specs


def _emb_scale(x) -> float:
    # sqrt(d_model) cast to the activation dtype first (45.25 in bf16 at d = 2048)
    return float(torch.tensor(math.sqrt(x.shape[-1]), dtype=x.dtype))


def _embed(params, cfg, batch):
    tokens = batch["tokens"]
    x = lookup(params["tok_emb"], tokens)
    if cfg.family == "vlm":
        patches = einsum("bpd,de->bpe", batch["patch_embeds"].to(x.dtype), params["patch_proj"])
        x = torch.cat([patches, x], dim=1)
    if cfg.emb_scale:
        x = x * _emb_scale(x)
    return shard(x.to(torch_dtype(cfg.dtype)), "batch", "seq", "act_embed")


def _logits(params, cfg, x):
    x = norm_apply(params, "final_norm", x, cfg.norm, cfg.norm_eps, plus_one=cfg.emb_scale)
    if cfg.tie_embeddings:
        logits = einsum("bsd,vd->bsv", x, params["tok_emb"])
    else:
        logits = einsum("bsd,dv->bsv", x, params["out_head"])
    return shard(logits, "batch", "seq", "vocab")


def _hybrid_sites(cfg) -> int:
    return cfg.n_layers // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0


def depth(stack) -> int:
    """The number of layers of a stacked block dict."""
    return stack["norm1" if "norm1" in stack else "norm1_w"].shape[0]


def _layer(tree, i):
    """Layer ``i`` of a stacked parameter dict or cache (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):  # a cache: its tensors, then its host pos
        return type(tree)(*(t[i] for t in tree[:-1]), tree.pos)
    return tree[i]


def unstack(stack) -> list:
    """The per-layer views of a stacked parameter tree, one ``unbind`` a
    leaf.  A gradient through them is stacked once, at the end of the
    backward; indexing the stack a layer at a time would instead make a
    zero-filled gradient of the whole stack for every layer and add it in."""
    leaves, spec = pytree.tree_flatten(stack)
    cols = [t.unbind(0) for t in leaves]
    return [pytree.tree_unflatten([c[i] for c in cols], spec) for i in range(len(cols[0]))]


def _advanced(cache):
    return type(cache)(*cache[:-1], cache.pos + 1)


def _stack_caches(caches):
    """Per-layer prefill caches stacked along a leading ``layers`` axis."""
    return type(caches[0])(*(torch.stack(leaves) for leaves in zip(*(c[:-1] for c in caches))), caches[0].pos)


def _layer_body(cfg, kind, mode, window, impl, site, cache, site_cache):
    """One layer of a segment as ``body(x, p, shared, emb0, positions) -> (x,
    aux, cache, site cache)``: the block and, at a hybrid site (``site`` not None), the
    weight-shared attention over ``[x, emb0]`` -- the unit the reference
    checkpoints.  Everything but its arguments is bound here, so a remat's
    backward recomputes this layer and no other."""

    def body(x, p, shared, emb0, positions):
        x, c_out, aux = _block_apply(p, x, cfg, kind, positions, mode, window, cache, impl)
        x = shard(x, "batch", "seq", "act_embed")
        c_site = None
        if site is not None:
            h = einsum("bsd,de->bse", torch.cat([x, emb0], dim=-1), shared["w_concat"])
            h2, c_site, _ = _block_apply(shared, h, cfg, "attn_mlp", positions, mode, window, site_cache, impl)
            x = x + h2
        return x, aux, c_out, c_site

    return body


def _run_segment(params, cfg, si, kind, x, positions, mode, window, caches, impl, emb0=None):
    """Run a stacked segment layer by layer, each layer through ``remat``
    where ``cfg.remat`` and ``mode == "train"``.  Returns (x, shared
    attention caches, the segment's caches, aux)."""
    seg = params[f"seg{si}"]
    n = depth(seg)
    every = cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    shared = params.get("shared_attn")
    attn_caches = caches.get("shared") if (every and caches is not None) else None
    seg_caches = caches.get(f"seg{si}") if (caches is not None and mode == "decode") else None
    rematted = cfg.remat and mode == "train"
    layers = unstack(seg)
    outs, site_outs, aux = [], [], None
    for li in range(n):
        site = (li + 1) // every - 1 if every and (li + 1) % every == 0 else None
        c_in = _layer(seg_caches, li) if seg_caches is not None else None
        c_site = _layer(attn_caches, site) if (site is not None and mode == "decode") else None
        body = _layer_body(cfg, kind, mode, window, impl, site, c_in, c_site)
        site_args = (shared, emb0) if site is not None else (None, None)
        if rematted:  # train mode: no caches; the body's outputs are x and the MoE's aux
            out = remat(lambda *a, body=body: tuple(t for t in body(*a)[:2] if t is not None),
                        x, layers[li], *site_args, positions)
            x, a, c_out, c2 = out[0], (out[1] if len(out) > 1 else None), None, None
        else:
            x, a, c_out, c2 = body(x, layers[li], *site_args, positions)
        outs.append(c_out)
        if a is not None:
            aux = a if aux is None else aux + a
        if mode == "prefill" and site is not None:
            site_outs.append(c2)
    if site_outs:
        attn_caches = _stack_caches(site_outs)
    if mode == "decode":
        new_caches = _advanced(seg_caches)
        if attn_caches is not None:
            attn_caches = _advanced(attn_caches)
    elif mode == "prefill":
        new_caches = _stack_caches(outs)
    else:
        new_caches = None
    return x, attn_caches, new_caches, aux


def forward(params, cfg, batch, mode: str = "train", window: int = 0, impl: str = "einsum"):
    """Full-sequence forward. Returns (logits, caches, (aux, mtp_logits))."""
    x = _embed(params, cfg, batch)
    B, S = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        if cfg.mrope_sections is not None:
            positions = positions[None].expand(3, B, S)
    # the hybrid's sites read the embeddings through a node of their own, so
    # their gradients sum apart from the residual stream's and then join it
    # in one order, rematerialised or not
    emb0 = x.view_as(x) if cfg.family == "hybrid" else None
    caches_out: Dict[str, Any] = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    attn_caches_final = None
    for si, (kind, n) in enumerate(segments_of(cfg)):
        x, attn_caches_final, new_caches, aux = _run_segment(
            params, cfg, si, kind, x, positions, mode, window, None, impl, emb0
        )
        if aux is not None:
            aux_total = aux_total + aux
        if mode == "prefill":
            caches_out[f"seg{si}"] = new_caches
    if mode == "prefill" and attn_caches_final is not None:
        caches_out["shared"] = attn_caches_final
    logits = _logits(params, cfg, x)
    if cfg.mtp and mode == "train":
        # DeepSeek-style multi-token prediction: fuse h_t with emb(token_{t+1})
        # to predict token_{t+2}
        emb_next = lookup(params["tok_emb"], batch["tokens"])[:, 1:]
        h = norm_apply(params, "mtp_norm", x[:, :-1], cfg.norm, cfg.norm_eps, plus_one=cfg.emb_scale)
        fused = einsum("bsd,de->bse", torch.cat([h, emb_next.to(h.dtype)], -1), params["mtp_proj"])
        return logits, caches_out or None, (aux_total, _logits(params, cfg, fused))
    return logits, caches_out or None, (aux_total, None)


def decode_step(params, cfg, tokens, caches, window: int = 0):
    """tokens: (B, 1). caches: dict seg{i} -> stacked cache (+ 'shared'),
    updated in place and returned with ``pos + 1``."""
    x = lookup(params["tok_emb"], tokens)
    if cfg.emb_scale:
        x = x * _emb_scale(x)
    x = x.to(torch_dtype(cfg.dtype))
    emb0 = x if cfg.family == "hybrid" else None
    new_caches = {}
    attn_caches = caches.get("shared")
    for si, (kind, n) in enumerate(segments_of(cfg)):
        x, attn_caches, seg_new, _ = _run_segment(
            params, cfg, si, kind, x, None, "decode", window, {**caches, "shared": attn_caches}, "einsum", emb0
        )
        new_caches[f"seg{si}"] = seg_new
    if attn_caches is not None:
        new_caches["shared"] = attn_caches
    return _logits(params, cfg, x), new_caches


def _stacked(cache, n):
    return type(cache)(*(t.unsqueeze(0).repeat(n, *([1] * t.dim())) for t in cache[:-1]), cache.pos)


def _shared_caches(cfg, B, S_cache, window, dtype, device):
    return _stacked(attn_mod.init_kv_cache(cfg, B, S_cache, window, dtype, device), _hybrid_sites(cfg))


def init_caches(cfg, B: int, S_cache: int, window: int = 0, dtype=torch.bfloat16, device=None):
    """Stacked decode caches per segment (+ hybrid shared-attn sites)."""
    out = {}
    for si, (kind, n) in enumerate(segments_of(cfg)):
        if kind == "ssm":
            c = ssm_mod.init_ssm_cache(cfg, B, dtype, device)
        elif kind.startswith("mla"):
            c = mla_mod.init_mla_cache(cfg, B, S_cache, window, dtype, device)
        else:
            c = attn_mod.init_kv_cache(cfg, B, S_cache, window, dtype, device)
        out[f"seg{si}"] = _stacked(c, n)
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        out["shared"] = _shared_caches(cfg, B, S_cache, window, dtype, device)
    return out


def pad_caches(caches, margin: int, window: int = 0):
    """Grow prefilled KV/latent caches by ``margin`` decode slots (seq axis=2
    of the layer-stacked tensors).  Ring-buffer (windowed) and SSM caches are
    fixed-size and pass through unchanged."""
    if margin <= 0 or window > 0 or caches is None:
        return caches

    def grow(a):
        shape = list(a.shape)
        shape[2] = margin
        return torch.cat([a, a.new_zeros(shape)], dim=2)

    def pad(c):
        if isinstance(c, (attn_mod.KVCache, mla_mod.MLACache)):
            return type(c)(*(grow(t) for t in c[:-1]), c.pos)
        return c

    return {name: pad(c) for name, c in caches.items()}


def cache_specs(cfg):
    """Logical-axis tuples mirroring ``init_caches`` structure."""
    out = {}
    for si, (kind, n) in enumerate(segments_of(cfg)):
        if kind == "ssm":
            c = ssm_mod.SSMCache(
                ("layers", "batch", None, "ssm_inner"),
                ("layers", "batch", "ssm_inner", "ssm_state", None),
                ("layers",),
            )
        elif kind.startswith("mla"):
            c = mla_mod.MLACache(
                ("layers", "batch", "cache_seq", None),
                ("layers", "batch", "cache_seq", None),
                ("layers",),
            )
        else:
            c = attn_mod.KVCache(
                ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
                ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
                ("layers",),
            )
        out[f"seg{si}"] = c
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        out["shared"] = attn_mod.KVCache(
            ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
            ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
            ("layers",),
        )
    return out


def vlm_positions(cfg, B: int, S: int, device=None) -> torch.Tensor:
    """Qwen2-VL M-RoPE position ids (3, B, S) int32: one image of n_patches
    in a square grid followed by text."""
    P = cfg.n_patches
    g = int(math.sqrt(P))
    ar = torch.arange(P, dtype=torch.int32, device=device)
    t_img = torch.zeros((P,), dtype=torch.int32, device=device)
    text = torch.arange(S - P, dtype=torch.int32, device=device) + g  # offset past image extent
    pos3 = torch.stack([torch.cat([t_img, text]), torch.cat([ar // g, text]), torch.cat([ar % g, text])])
    return pos3[:, None, :].expand(3, B, S)

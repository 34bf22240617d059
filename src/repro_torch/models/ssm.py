"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) layer, the port of
``repro.models.ssm``.

Layout per layer (d_in = expand*d_model, H = d_in/headdim heads, P = headdim,
G = ngroups, N = ssm_state):

    in_proj:  d -> [z(d_in) | x(d_in) | B(G*N) | C(G*N) | dt(H)]
    conv1d:   depthwise causal width-4 over the (x|B|C) channels
    SSD:      y_t = C_t^T h_t ;  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T
    gate:     y = RMSNorm(y * silu(z)) ; out_proj: d_in -> d

Training/prefill uses the chunked SSD algorithm (quadratic within chunks of
length Q, linear across chunks through a carried (b, H, N, P) state: the
reference's scan over chunks is a loop here).  Decode is the O(1)
recurrence with a conv ring state; ``ssm_decode`` writes the new ring and
state into the cache's buffers in place, as attention decode does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import ParamBuilder, rmsnorm
from .sharding import einsum, on_rows, shard

__all__ = ["SSMCache", "ssm_init", "ssm_apply", "ssm_decode", "init_ssm_cache", "ssd_chunked"]


class SSMCache(NamedTuple):
    conv: torch.Tensor  # (B, W-1, conv_channels) trailing inputs
    state: torch.Tensor  # (B, H, N, P) ssm state
    pos: int


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_headdim
    H = d_in // P
    G = cfg.ssm_ngroups
    N = cfg.ssm_state
    return d_in, H, P, G, N


def ssm_init(pb: ParamBuilder, cfg):
    d = cfg.d_model
    d_in, H, P, G, N = _dims(cfg)
    conv_ch = d_in + 2 * G * N
    pb.p("in_proj", (d, 2 * d_in + 2 * G * N + H), ("embed", "ssm_inner"), fan_in=d)
    pb.p("conv_w", (cfg.ssm_conv_width, conv_ch), (None, "ssm_inner"), fan_in=cfg.ssm_conv_width)
    pb.p("conv_b", (conv_ch,), ("ssm_inner",), init="zeros")
    pb.p("A_log", (H,), ("ssm_inner",), init="zeros")  # A = -exp(A_log) = -1 at init
    pb.p("D", (H,), ("ssm_inner",), init="ones")
    pb.p("dt_bias", (H,), ("ssm_inner",), init="zeros")
    pb.p("gate_norm", (d_in,), ("ssm_inner",), init="ones")
    pb.p("out_proj", (d_in, d), ("ssm_inner", "embed"), fan_in=d_in)


def _split_proj(cfg, h):
    d_in, H, P, G, N = _dims(cfg)
    z = h[..., :d_in]
    xbc = h[..., d_in: 2 * d_in + 2 * G * N]
    dt = h[..., 2 * d_in + 2 * G * N:]
    return z, xbc, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv. xbc: (B,S,C); w: (W,C)."""
    W = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = pad[:, 0:S, :] * w[0]
    for i in range(1, W):
        out = out + pad[:, i: i + S, :] * w[i]
    return F.silu(out + b)


def _decay_A(p, dtype):
    return (-torch.exp(p["A_log"].to(torch.float32))).to(dtype)


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None, return_final=False):
    """Chunked SSD scan.

    Args:
      x:  (b, S, H, P) inputs (after conv/activation)
      dt: (b, S, H) positive step sizes
      A:  (H,) negative decay rates
      B:  (b, S, G, N); C: (b, S, G, N)
      chunk: chunk length Q (S is padded to a multiple of Q)
    Returns y (b,S,H,P) [, final_state (b,H,N,P)].
    """
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(chunk, S)
    if S % Q:  # pad to a chunk multiple; dt=0 makes padding inert
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    S_pad = x.shape[1]
    nc = S_pad // Q
    rep = H // G

    xc = x.reshape(b, nc, Q, H, P)
    dtc = dt.reshape(b, nc, Q, H)
    Bh = torch.repeat_interleave(B.reshape(b, nc, Q, G, N), rep, dim=3)  # (b,nc,Q,H,N)
    Ch = torch.repeat_interleave(C.reshape(b, nc, Q, G, N), rep, dim=3)

    dA = dtc * A[None, None, None, :]  # (b,nc,Q,H) negative
    cum = torch.cumsum(dA, dim=2)  # within-chunk cumulative log-decay
    total = cum[:, :, -1]  # (b,nc,H)

    # ---- intra-chunk (quadratic within Q) ----
    Li = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,Q,Q,H)
    mask = (torch.arange(Q, device=x.device)[:, None] >= torch.arange(Q, device=x.device)[None, :])[None, None, :, :, None]
    L = torch.where(mask, torch.exp(Li), 0.0)
    scores = einsum("bcihn,bcjhn->bcijh", Ch, Bh)  # (b,nc,Q,Q,H)
    att = scores * L * dtc[:, :, None, :, :]  # weight by dt_j
    y_intra = einsum("bcijh,bcjhp->bcihp", att, xc)

    # ---- chunk states ----
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # (b,nc,Q,H)
    S_chunk = einsum("bcqh,bcqhn,bcqhp->bchnp", dtc * decay_to_end, Bh, xc)

    # ---- inter-chunk recurrence ----
    s = initial_state if initial_state is not None else torch.zeros((b, H, N, P), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(s)  # state entering chunk c
        s = s * torch.exp(total[:, c])[:, :, None, None] + S_chunk[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b,nc,H,N,P)

    y_inter = einsum("bcqhn,bchnp,bcqh->bcqhp", Ch, prev_states, torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, S_pad, H, P)[:, :S]
    if return_final:
        return y, s
    return y


_MIXER = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "gate_norm")  # the SSD's own (small) parameters


def _mixer(p, h, cfg, mode: str):
    """in_proj's output ``h`` (B,S,e) -> the gated SSD output (B,S,d_in),
    and in prefill the conv ring and the final state."""
    d_in, H, P, G, N = _dims(cfg)
    B_, S_ = h.shape[:2]
    z, xbc_raw, dt = _split_proj(cfg, h)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xs = xbc[..., :d_in]
    Bm = xbc[..., d_in: d_in + G * N].reshape(B_, S_, G, N)
    Cm = xbc[..., d_in + G * N:].reshape(B_, S_, G, N)
    dt = F.softplus(dt + p["dt_bias"])  # (B,S,H)
    A = _decay_A(p, h.dtype)
    xh = xs.reshape(B_, S_, H, P)
    y, final = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk, return_final=True)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(B_, S_, d_in)
    y = rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    if mode != "prefill":
        return y, None, None
    W = cfg.ssm_conv_width
    # the raw pre-conv trailing inputs (the reference computes the same
    # in_proj product again; this is that product's slice)
    conv_state = xbc_raw[:, -(W - 1):, :]
    pad = W - 1 - conv_state.shape[1]
    if pad > 0:
        conv_state = F.pad(conv_state, (0, 0, pad, 0))
    return y, conv_state.contiguous(), final


def ssm_apply(p, x, cfg, mode: str = "train", impl: str = "einsum"):
    """x: (B,S,d) -> (B,S,d) [, cache].  On a mesh the mixer between the two
    projections runs on each rank's batch rows with every feature
    (``sharding.on_rows``): its slices of in_proj's output at the z / x / B
    / C / dt boundaries do not follow a feature sharding."""
    h = einsum("bsd,de->bse", x, p["in_proj"])
    y, conv_state, final = on_rows(lambda hh, *small: _mixer(dict(zip(_MIXER, small)), hh, cfg, mode),
                                   shard(h, "batch", "seq", None), *(p[k] for k in _MIXER))
    out = einsum("bse,ed->bsd", y, p["out_proj"])
    if mode == "prefill":
        return out, SSMCache(conv_state, final, x.shape[1])
    return out, None


def init_ssm_cache(cfg, B: int, dtype=torch.bfloat16, device=None) -> SSMCache:
    d_in, H, P, G, N = _dims(cfg)
    conv_ch = d_in + 2 * G * N
    return SSMCache(
        torch.zeros((B, cfg.ssm_conv_width - 1, conv_ch), dtype=dtype, device=device),
        torch.zeros((B, H, N, P), dtype=dtype, device=device),
        0,
    )


def _decode_mixer(p, h, conv, state, cfg):
    """One token's in_proj output ``h`` (B, e), the conv ring and the state
    -> (the gated output (B, d_in), the new ring, the new state)."""
    d_in, H, P, G, N = _dims(cfg)
    z = h[..., :d_in]
    xbc_new = h[..., d_in: 2 * d_in + 2 * G * N]
    dt = h[..., 2 * d_in + 2 * G * N:]
    # conv over ring of last W inputs
    inputs = torch.cat([conv, xbc_new[:, None, :]], dim=1)  # (B,W,C)
    cv = einsum("bwc,wc->bc", inputs, p["conv_w"]) + p["conv_b"]
    xbc = F.silu(cv)
    xs = xbc[..., :d_in].reshape(-1, H, P)
    Bm = xbc[..., d_in: d_in + G * N].reshape(-1, G, N)
    Cm = xbc[..., d_in + G * N:].reshape(-1, G, N)
    rep = H // G
    Bh = torch.repeat_interleave(Bm, rep, dim=1)  # (B,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1)
    dt = F.softplus(dt + p["dt_bias"])  # (B,H)
    A = _decay_A(p, h.dtype)
    decay = torch.exp(dt * A)[:, :, None, None]  # (B,H,1,1)
    upd = einsum("bh,bhn,bhp->bhnp", dt, Bh, xs)
    state = state * decay + upd
    y = einsum("bhn,bhnp->bhp", Ch, state) + p["D"][None, :, None] * xs
    y = y.reshape(h.shape[0], d_in)
    return rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps), inputs[:, 1:], state


def ssm_decode(p, x, cfg, cache: SSMCache):
    """One-token recurrent step. x: (B,1,d).  The ring and the state are
    written into ``cache``'s buffers (on a mesh the mixer runs as in
    ``ssm_apply``, on each rank's rows)."""
    h = einsum("bsd,de->bse", x, p["in_proj"])[:, 0]  # (B, e)
    y, ring, state = on_rows(
        lambda hh, cv, st, *small: _decode_mixer(dict(zip(_MIXER, small)), hh, cv, st, cfg),
        shard(h, "batch", None), shard(cache.conv, "batch", None, None), shard(cache.state, "batch", None, None, None),
        *(p[k] for k in _MIXER))
    out = einsum("be,ed->bd", y, p["out_proj"])[:, None, :]
    cache.conv.copy_(ring)
    cache.state.copy_(state)
    return out, SSMCache(cache.conv, cache.state, cache.pos + 1)

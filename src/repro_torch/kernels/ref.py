"""Plain PyTorch versions of the port's kernels.

Each repeats its kernel's arithmetic with the staged engine's operations in
the staged engine's order (``repro.kernels.ref`` and
``repro.kernels.unpack_bits``), so the fused round on the CPU equals the
staged round, and ``chip_smoke.py`` holds each CUDA kernel against its plain
version on the card.  A wrapper in ``unpack_bits.py`` / ``round_fused.py`` /
``bisect_tiles.py`` / ``gumbel_topk.py`` / ``e3cs_tiles.py`` takes these only
for tensors that lie on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.selection.e3cs import divide
from repro_torch.core.selection.prob_alloc import clip_sigma_one
from repro_torch.core.selection.sampling import top_k
from repro_torch.core.volatility import DEAD_LAG

__all__ = [
    "LAG_DEAD_CODE",
    "unpack_bits_ref",
    "unpack_crumbs_ref",
    "fused_alloc_select_ref",
    "fused_perturb_select_ref",
    "round_tail_ref",
    "ring_pop_push",
    "bisect_block_sums_ref",
    "gumbel_topk_ref",
    "gumbel_topk_kernel_ref",
    "fused_gumbel_scores",
    "fused_gumbel_topk_kernel_ref",
    "e3cs_update_kernel_ref",
    "e3cs_update_tiled_ref",
    "scalar_f32",
    "threefry_ref",
    "threefry_rows_ref",
    "categorical_ref",
    "erf_inv_ref",
    "THREEFRY_MODES",
    "NORMAL_LO",
]

LAG_DEAD_CODE = 3  # 2-bit crumb sentinel of a client that never completes
_EPS = 1e-20


def scalar_f32(v, device) -> torch.Tensor:
    """``v`` as a float32 0-d tensor on ``device``, rounded once.  A plain
    version divides and multiplies by such a tensor, never by a Python
    number (on CUDA PyTorch divides by a Python number as a multiply by its
    reciprocal)."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def gumbel_topk_ref(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k indices of perturbed scores, int32, in ``lax.top_k`` order."""
    return top_k(scores, k)[1]


def gumbel_topk_kernel_ref(scores: torch.Tensor, k: int):
    """The top-k kernel's products: ``(vals, idx)`` of ``scores`` in
    ``lax.top_k`` order (value descending, ties by index ascending)."""
    return top_k(scores, k)


def fused_gumbel_scores(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``log(max(p, 1e-20)) + Gumbel(u)`` with ``Gumbel(u) =
    -log(-log(clip(u, 1e-20, 1 - 1e-7)))``, ``-inf`` where ``p <= 0``."""
    g = -torch.log(-torch.log(torch.clamp(u, _EPS, 1.0 - 1e-7)))
    s = torch.log(torch.clamp(p, min=_EPS)) + g
    return torch.where(p > 0, s, torch.full_like(s, float("-inf")))


def fused_gumbel_topk_kernel_ref(p: torch.Tensor, u: torch.Tensor, k: int):
    """The fused kernel's products: ``(vals, idx)``, the top k of
    ``fused_gumbel_scores(p, u)``.  With fewer than k positive ``p`` the tail
    is ``-inf`` at the lowest indices with ``p <= 0``."""
    return top_k(fused_gumbel_scores(p, u), k)


def _e3cs_new(logw, p, sel_mask, x, frozen, scale):
    xhat = sel_mask * x / torch.clamp(p, min=1e-12)  # Eq. (16)
    step = torch.clamp(scalar_f32(scale, logw.device) * xhat, max=1.0)  # Eq. (17) exponent, proof clamp
    return logw + torch.where(frozen > 0, torch.zeros_like(step), step)


def e3cs_update_kernel_ref(logw, p, sel_mask, x, frozen, scale, tile: int = 8192):
    """The update kernel's products: ``(new_logw, tmax)``, ``tmax`` the max
    of ``new_logw`` over each tile of ``min(tile, max(K, 8))`` clients
    (``ceil(K / tile)`` entries, as the Pallas call's grid)."""
    new = _e3cs_new(logw, p, sel_mask, x, frozen, scale)
    K = new.shape[0]
    tile = min(tile, max(K, 8))
    pad = new.new_full(((-K) % tile,), float("-inf"))
    return new, torch.cat([new, pad]).reshape(-1, tile).amax(dim=1)


def e3cs_update_tiled_ref(logw, p, sel_mask, x, frozen, scale):
    """The tiled update and its re-centring: ``new - max(new)``."""
    new = _e3cs_new(logw, p, sel_mask, x, frozen, scale)
    return new - torch.max(new)


def bisect_block_sums_ref(w: torch.Tensor, caps: torch.Tensor, tile: int = 8192) -> torch.Tensor:
    """``(n_caps,)`` capped sums ``s_b = sum_j min(w_j, caps_b)`` in ``w``'s
    dtype, summed per ``tile``-client tile and then across tiles, as
    ``repro.kernels.bisect_tiles.bisect_block_sums_ref`` sums them.  Padding
    entries of ``w`` are 0 and ``caps >= 0``, so padding adds nothing."""
    n = w.shape[0]
    tile = min(tile, max(n, 1))
    pad = (-n) % tile
    if pad:
        w = torch.cat([w, w.new_zeros(pad)])
    caps = caps.to(w.dtype)
    per_tile = torch.minimum(w.reshape(-1, tile)[:, None, :], caps[None, :, None]).sum(dim=2)
    return per_tile.sum(dim=0)


def unpack_bits_ref(packed: torch.Tensor, K: int) -> torch.Tensor:
    """Little-endian bit expansion: ``(..., B)`` uint8 -> ``(..., K)`` float32."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)[..., :K].to(torch.float32)


def unpack_crumbs_ref(packed: torch.Tensor, K: int) -> torch.Tensor:
    """Little-endian 2-bit expansion: ``(..., B)`` uint8 -> ``(..., K)`` int32
    codes in {0, 1, 2, 3}, 4 clients per byte."""
    shifts = torch.arange(4, dtype=torch.uint8, device=packed.device) * 2
    crumbs = (packed[..., None] >> shifts) & 3
    return crumbs.reshape(*packed.shape[:-1], packed.shape[-1] * 4)[..., :K].to(torch.int32)


def _select_scores(p, g, active):
    s = torch.log(torch.clamp(p, min=1e-20)) + g
    if active is not None:
        s = torch.where(active > 0, s, torch.full_like(s, float("-inf")))
    return s


def fused_alloc_select_ref(w, g, k: int, *, sigma, scalars, active=None):
    """Allocation epilogue + perturb + top-k.  ``scalars = (residual, cap,
    denom, use_cap)`` from ``masked_prob_alloc_scalars``.  Returns ``(p,
    capped, vals, idx)``."""
    residual, cap, denom, use_cap = scalars
    p = sigma + residual * torch.minimum(w, cap) / denom
    capped = (p >= 1.0 - 1e-6) & use_cap
    p = clip_sigma_one(p, sigma)
    if active is not None:
        p = p * active
        capped = capped & (active > 0)
    vals, idx = top_k(_select_scores(p, g, active), k)
    return p, capped, vals, idx


def fused_perturb_select_ref(p, g, k: int, *, active=None):
    """Perturb + top-k only (``p`` already allocated): ``(vals, idx)``."""
    return top_k(_select_scores(p, g, active), k)


def decode_obs(obs, kind: str, K: int):
    """Outcome row -> ``(x, lag)``: ``lag`` is None for the sync kinds, and
    ``x = 1{lag == 0}`` (deadline feedback) for the async ones."""
    lag = None
    if kind == "bits":
        x = unpack_bits_ref(obs, K)
    elif kind == "crumbs":
        codes = unpack_crumbs_ref(obs, K)
        lag = torch.where(codes == LAG_DEAD_CODE, torch.full_like(codes, DEAD_LAG), codes)
    elif kind == "x":
        x = obs
    elif kind == "lag":
        lag = obs
    else:
        raise ValueError(f"unknown obs kind {kind!r}")
    if lag is not None:
        x = (lag == 0).to(torch.float32)
    return x, lag


def ring_pop_push(pending, sched):
    """One bounded-ring update: pop slot 0 (due now), shift, add the newly
    scheduled rows (slot s lands s + 1 rounds from now).  ``pending`` and
    ``sched`` are ``(..., S, K)``: any leading batch axes (the multi-job J
    axis) ride along.  Returns ``(arriving, new_pending)``."""
    shifted = torch.cat([pending[..., 1:, :], torch.zeros_like(pending[..., :1, :])], dim=-2)
    return pending[..., 0, :], shifted + sched


def round_tail_ref(
    obs, mask, p, capped, logw, loss_cache, credit, fb, *,
    kind: str, residual, eta: float, K_glob: int, decay=(), active: Optional[torch.Tensor] = None,
):
    """Observe-decode + E3CS elementwise update + credit rings.  Returns a
    dict of every tail product; the global re-centring stays with the caller
    (``m`` is the masked max it needs)."""
    K = mask.shape[0]
    x, lag = decode_obs(obs, kind, K)
    xhat = mask * x / torch.clamp(p, min=1e-12)
    step = divide(residual * eta * xhat, K_glob)
    step = torch.clamp(step, max=1.0)
    frozen = capped if active is None else capped | (active == 0)
    logw_pre = logw + torch.where(frozen, torch.zeros_like(step), step)
    if active is None:
        m = torch.max(logw_pre)
    else:
        m = torch.max(torch.where(active > 0, logw_pre, torch.full_like(logw_pre, float("-inf"))))
    out = {
        "x": x,
        "logw_pre": logw_pre,
        "m": m,
        "loss_cache": torch.where(mask > 0, 1.0 - x, loss_cache),
    }
    if lag is not None:
        out["lag"] = lag
    S = len(decay)
    if credit is not None and S > 0:
        dec = torch.stack([torch.full((), d, dtype=torch.float32, device=mask.device) for d in decay])
        lag_rows = torch.arange(1, S + 1, dtype=torch.int32, device=mask.device)
        sched = mask[None, :] * (lag[None, :] == lag_rows[:, None]) * dec[:, None]
        out["arriving"], out["credit"] = ring_pop_push(credit, sched)
        if fb is not None:
            xhat_rows = sched / torch.clamp(p, min=1e-12)
            rows = torch.clamp(divide(residual * eta * xhat_rows, K_glob), max=1.0)
            rows = torch.where(frozen, torch.zeros_like(rows), rows)
            out["arr_fb"], out["fb"] = ring_pop_push(fb, rows)
    return out


# -- threefry2x32 (the JAX key stream's hash; core/prng.py) -------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
THREEFRY_MODES = ("keys", "bits", "sortkey", "uniform", "gumbel", "normal")
NORMAL_LO = -0.99999994  # jax.random.normal's lower end, nextafter(-1, 0) in float32
_SQRT2 = 1.41421354  # sqrt(2) in float32
# XLA's float32 erf_inv (ErfInv32): Giles' coefficients for w < 5 and w >= 5
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GT = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _threefry2x32(k0, k1, x0, x1):
    """JAX's threefry2x32 with 20 rounds (``jax._src.prng._threefry2x32_lowering``)
    on int32 tensors holding the uint32 words' bits: adds wrap as uint32
    adds do, and a rotate masks the arithmetic right shift to a logical one."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << r) | ((x1 >> (32 - r)) & ((1 << r) - 1))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def _as_int32(v) -> torch.Tensor:
    """Values in ``[0, 2**32)`` (an int64 tensor) as the int32 tensor of the
    same bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _word(d: int, device) -> torch.Tensor:
    """A 32-bit word as a 0-d int32 tensor of its bits."""
    d &= _M32
    return torch.tensor(d - 2**32 if d >= 2**31 else d, dtype=torch.int32, device=device)


def _float_bits(bits: torch.Tensor) -> torch.Tensor:
    """``[0, 1)`` float32 from 32 random bits (int32): the top 23 as the
    mantissa of a float in ``[1, 2)``, minus 1 (``jax.random.uniform``)."""
    return (((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0


def erf_inv_ref(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` as its CPU backend evaluates it: Giles'
    polynomial in ``w = -log1p(-x * x)`` (``w - 2.5`` below 5, ``sqrt(w) - 3``
    above), each multiply-add rounded once (a float64 product and sum, both
    exact but for the sum's one rounding, rounded to float32)."""
    w = -torch.log1p(-(x * x))
    small = w < 5.0

    def coef(i):
        return torch.where(small, torch.tensor(_ERFINV_LT[i], dtype=torch.float32, device=x.device),
                           torch.tensor(_ERFINV_GT[i], dtype=torch.float32, device=x.device))

    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = coef(0)
    for i in range(1, 9):
        p = (coef(i).double() + p.double() * w).to(torch.float32)
    return p * x


# Counters the plain version hashes at a time on the CPU: an elementwise op
# on fewer elements than ATen's grain size (32768) runs on the calling
# thread, so the ~150 small ops of a hash do not wait on the intra-op thread
# pool (on a loaded CPU each parallel op costs far more than its arithmetic).
_CHUNK = 32768


def _fold(k0, k1, path):
    """The key words ``(k0, k1)`` (int32) folded by each of ``path``."""
    for d in path:
        k0, k1 = _threefry2x32(k0, k1, _word(int(d) >> 32, k0.device), _word(int(d), k0.device))
    return k0, k1


def _hash(k0, k1, offset: int, n: int):
    """The pairs ``(a, b)`` (int32) of counters ``offset .. offset + n - 1``
    under the key ``(k0, k1)`` (int32 words)."""
    c = torch.arange(n, dtype=torch.int64, device=k0.device) + int(offset)
    return _threefry2x32(k0, k1, _as_int32(c >> 32), _as_int32(c & _M32))


def _chunked(k0, k1, path, offset: int, n: int, draw, width: int = 1, axis: int = 0) -> torch.Tensor:
    """``draw(a, b)`` over counters ``offset .. offset + n - 1`` under the key
    folded by ``path``, on the CPU ``_CHUNK // width`` counters at a time
    (``width`` keys side by side), joined along ``axis``, the counters' axis
    of ``draw``'s result."""
    k0, k1 = _fold(k0, k1, path)
    step = max(1, _CHUNK // width) if k0.device.type == "cpu" else max(n, 1)
    parts = [draw(*_hash(k0, k1, offset + s, min(step, n - s))) for s in range(0, max(n, 1), step)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis)


def _pairs(k0, k1, j0: int, cnt: int, h: int, m: int):
    """The original layout's outputs ``(y0, y1)`` (int32) of its counter
    pairs ``j0 .. j0 + cnt - 1`` in a draw of ``m`` words: pair ``j`` hashes
    ``(j, j + h)``, the second counter 0 where ``j + h`` is past the end."""
    j = torch.arange(cnt, dtype=torch.int64, device=k0.device) + int(j0)
    x1 = torch.where(j + h < m, j + h, torch.zeros_like(j))
    return _threefry2x32(k0, k1, _as_int32(j), _as_int32(x1))


_BLOCK = 2**32 - 1  # JAX draws this many original-layout words or more in blocks under split keys


def _original(k0, k1, path, w_lo: int, w_hi: int, m: int, draw, width: int = 1, axis: int = 0) -> torch.Tensor:
    """``draw(words)`` over the words ``w_lo .. w_hi - 1`` of a draw of ``m``
    words in the original layout (``threefry_ref``) under the key folded by
    ``path``, on the CPU ``_CHUNK // width`` pairs at a time (``width`` keys
    side by side), joined along ``axis``.  Each pair is hashed once: word
    ``j`` and word ``j + h`` come from the same hash.  A draw of ``_BLOCK``
    words or more is JAX's blocked draw (``_threefry_random_bits_original``):
    with ``nblocks, rem = divmod(m, _BLOCK)`` the key is split into
    ``nblocks + 1`` keys, block ``b < nblocks`` is the draw of ``_BLOCK``
    words under key ``b``, the last the draw of ``rem`` words under the last
    key; only the blocks' words in the range are hashed."""
    if not 0 <= w_lo <= w_hi <= m:
        raise ValueError(f"words {w_lo} .. {w_hi} are not in a draw of {m}")
    k0, k1 = _fold(k0, k1, path)
    nblocks = m // _BLOCK
    if not nblocks or w_hi == w_lo:
        return _one_draw(k0, k1, w_lo, w_hi, min(m, _BLOCK) if w_hi == w_lo else m, draw, width, axis)
    # split(key, nblocks + 1): the draw of 2 (nblocks + 1) words, key b words 2b and 2b + 1
    n_keys = 2 * (nblocks + 1)
    parts = []
    for b in range(w_lo // _BLOCK, (w_hi - 1) // _BLOCK + 1):
        base, mb = b * _BLOCK, _BLOCK if b < nblocks else m - nblocks * _BLOCK
        kb = _one_draw(k0, k1, 2 * b, 2 * b + 2, n_keys, lambda y: y, width, axis)
        kb0, kb1 = kb.narrow(axis, 0, 1), kb.narrow(axis, 1, 1)
        if width == 1:
            kb0, kb1 = kb0.reshape(()), kb1.reshape(())
        parts.append(_one_draw(kb0, kb1, max(w_lo, base) - base, min(w_hi, base + mb) - base, mb, draw, width, axis))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis)


def _one_draw(k0, k1, w_lo: int, w_hi: int, m: int, draw, width: int, axis: int) -> torch.Tensor:
    """``_original``'s words ``w_lo .. w_hi - 1`` of one draw of ``m <
    _BLOCK`` words (``m = _BLOCK``: a full block of a blocked draw) under
    the folded key ``(k0, k1)``."""
    h = (m + 1) // 2
    spans = ((w_lo, min(w_hi, h)), (max(w_lo, h) - h, w_hi - h))  # the words of each half, as pairs
    live = sorted(s for s in spans if s[1] > s[0])
    if not live:
        return draw(_pairs(k0, k1, 0, 0, h, m)[0])
    if len(live) == 2 and live[1][0] <= live[0][1]:  # the halves' pairs overlap: hash each pair once
        live = [(live[0][0], max(live[0][1], live[1][1]))]
    heads, tails = [], []
    for p_lo, p_hi in live:  # apart, a range of words across the halves hashes only its pairs
        step = max(1, _CHUNK // width) if k0.device.type == "cpu" else p_hi - p_lo
        for s in range(p_lo, p_hi, step):
            e = min(s + step, p_hi)
            y = _pairs(k0, k1, s, e - s, h, m)
            for (lo, hi), y_half, parts in zip(spans, y, (heads, tails)):
                a, b = max(s, lo), min(e, hi)
                if b > a:
                    parts.append(draw(y_half.narrow(-1, a - s, b - a)))
    parts = heads + tails
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis)


def _epilogue(a, b, mode: str, minval: float, maxval: float, device) -> torch.Tensor:
    if mode == "keys":
        return torch.stack([a, b], dim=-1)
    return _finish(a ^ b, mode, minval, maxval, device)


def _finish(bits, mode: str, minval: float, maxval: float, device) -> torch.Tensor:
    """A mode's output from 32 random bits a value (int32)."""
    if mode == "bits":
        return bits
    if mode == "sortkey":
        return bits ^ -(2**31)
    if mode == "gumbel":
        minval, maxval = torch.finfo(torch.float32).tiny, 1.0
    elif mode == "normal":
        minval, maxval = NORMAL_LO, 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    span = torch.tensor(maxval, dtype=torch.float32, device=device) - lo
    # one rounding of f * span + lo, as XLA's fused multiply-add takes it: the
    # float64 product of two float32 is exact, and so is the sum where both
    # ends lie within 2**-47 of each other's scale (every span and minval the
    # port draws with)
    fma = _float_bits(bits).double() * span.double() + lo.double()
    u = torch.maximum(lo, fma.to(torch.float32))
    if mode == "gumbel":
        return -torch.log(-torch.log(u))
    if mode == "normal":
        return torch.tensor(_SQRT2, dtype=torch.float32, device=device) * erf_inv_ref(u)
    return u


def threefry_rows_ref(keys: torch.Tensor, path: tuple, n: int, original: bool = False) -> torch.Tensor:
    """The plain version of the kernel's rows entry: row ``j`` of the
    ``(J, n)`` result is ``threefry_ref(keys[j], path, 0, n, "gumbel")``
    (``keys`` a ``(J, 2)`` int32 tensor), or with ``original`` the same
    row in the original layout (``total=n``: each row a draw of its own)."""
    if original:
        return _original(keys[:, :1], keys[:, 1:], path, 0, n, n,
                         lambda y: _finish(y, "gumbel", 0.0, 1.0, keys.device), width=keys.shape[0], axis=1)
    return _chunked(keys[:, :1], keys[:, 1:], path, 0, n,
                    lambda a, b: _epilogue(a, b, "gumbel", 0.0, 1.0, keys.device), width=keys.shape[0], axis=1)


def _gumbel_bf16(bits8: torch.Tensor) -> torch.Tensor:
    """JAX's bfloat16 Gumbel from 8 random bits a value (int32 in ``[0,
    256)``): their top 7 as the mantissa, each operation rounded to
    bfloat16."""
    tiny = torch.tensor(torch.finfo(torch.bfloat16).tiny, dtype=torch.bfloat16, device=bits8.device)
    f = ((bits8 >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16) - 1.0
    u = torch.maximum(tiny, f * (1.0 - tiny) + tiny)
    return -torch.log(-torch.log(u))


def categorical_ref(key: torch.Tensor, path: tuple, logits: torch.Tensor, original: bool = False) -> torch.Tensor:
    """The plain version of the kernel's categorical entry, JAX's
    ``categorical(key, logits)`` over the last axis of ``(B, V)`` logits:
    ``argmax(gumbel(key, (B, V), logits.dtype) + logits, -1)`` as int32, ties
    (and NaNs) to the lowest index.  Float32 logits take the ``"gumbel"``
    epilogue's noise; bfloat16 logits JAX's bfloat16 Gumbel: 8 random bits
    a value (``_uniform`` draws 8 bits for a type of 7 mantissa bits), their
    top 7 as the mantissa, each operation rounded to bfloat16.  The 8 bits
    are the low byte of ``a ^ b``; with ``original`` (the original layout)
    the values are one draw of ``B * V`` words, or of ``ceil(B * V / 4)``
    words for bfloat16, value ``i`` byte ``i % 4`` of word ``i // 4``."""
    B, V = logits.shape
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"categorical takes float32 or bfloat16 logits, got {logits.dtype}")
    n = B * V
    if not original:
        draw = (lambda a, b: _gumbel_bf16((a ^ b) & 0xFF)) if logits.dtype == torch.bfloat16 else (
            lambda a, b: _epilogue(a, b, "gumbel", 0.0, 1.0, key.device))
        g = _chunked(key[0], key[1], path, 0, n, draw)
    elif logits.dtype == torch.bfloat16:
        m = -(-n // 4)
        words = _original(key[0], key[1], path, 0, m, m, lambda y: y)
        shifts = torch.arange(0, 32, 8, dtype=torch.int32, device=key.device)
        g = _gumbel_bf16(((words[:, None] >> shifts) & 0xFF).reshape(-1)[:n])
    else:
        g = _original(key[0], key[1], path, 0, n, n, lambda y: _finish(y, "gumbel", 0.0, 1.0, key.device))
    return torch.argmax(g.view(B, V) + logits, dim=-1).to(torch.int32)


def threefry_ref(key: torch.Tensor, path: tuple, offset: int, n: int, mode: str, minval: float = 0.0,
                 maxval: float = 1.0, total: int = 0) -> torch.Tensor:
    """The plain version of the threefry kernel (``csrc/threefry.cu``).

    ``key`` is a ``(2,)`` int32 tensor holding a key's two uint32 words.  It
    is first folded by each of ``path`` in turn (``fold_in``: the key hashes
    the counter ``(d >> 32, d & 0xFFFFFFFF)``); then counter ``offset + i``
    for ``i < n`` is hashed into the pair ``(a_i, b_i)`` and ``mode`` makes
    the output: ``"keys"`` the ``(n, 2)`` int32 pairs (``split``),
    ``"bits"`` the ``(n,)`` int32 bits of ``a ^ b`` (32 random bits,
    partitionable mode), ``"sortkey"`` those bits minus ``2**31`` (their
    unsigned order as int32), ``"uniform"`` float32 in ``[minval, maxval)``,
    ``"gumbel"`` ``-log(-log(u))`` of ``u`` uniform in ``[tiny, 1)`` and
    ``"normal"`` ``sqrt(2) * erf_inv(u)`` of ``u`` uniform in ``[NORMAL_LO,
    1)`` (``jax.random.normal``; ``erf_inv_ref``).

    ``total > 0`` takes the original layout (JAX's
    ``jax_threefry_partitionable=False``): the values ``offset .. offset + n
    - 1`` of one draw of ``total`` values, a draw of ``m`` words (``total``,
    or ``2 * total`` for ``"keys"``: ``split(key, total)``) hashing the
    counter pairs ``(j, j + h)``, ``h = ceil(m / 2)``, for ``j < h`` (the
    second counter 0 past the end), word ``j`` the pair's first output and
    word ``j + h`` its second; each word is a value's 32 bits (no xor), and
    key ``i`` is words ``2i`` and ``2i + 1``.  A draw of ``2**32 - 1`` words
    or more is JAX's, in blocks under split keys (``_original``); a split
    (``"keys"``) draws fewer, as JAX's."""
    if mode not in THREEFRY_MODES:
        raise ValueError(f"unknown threefry mode {mode!r} (want one of {THREEFRY_MODES})")
    if not total:
        return _chunked(key[0], key[1], path, offset, n,
                        lambda a, b: _epilogue(a, b, mode, minval, maxval, key.device))
    if mode == "keys":
        if 2 * total > _M32:
            raise ValueError(f"split({total}) in the original layout is a draw of {2 * total} words; JAX's original "
                             "split draws at most 2**32 - 1")
        return _original(key[0], key[1], path, 2 * offset, 2 * (offset + n), 2 * total, lambda y: y).view(n, 2)
    return _original(key[0], key[1], path, offset, offset + n, total,
                     lambda y: _finish(y, mode, minval, maxval, key.device))

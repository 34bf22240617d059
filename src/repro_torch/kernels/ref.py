"""Plain PyTorch versions of the port's kernels.

Each repeats its kernel's arithmetic with the staged engine's operations in
the staged engine's order (``repro.kernels.ref`` and
``repro.kernels.unpack_bits``), so the fused round on the CPU equals the
staged round, and ``chip_smoke.py`` holds each CUDA kernel against its plain
version on the card.  A wrapper in ``unpack_bits.py`` / ``round_fused.py``
takes these only for tensors that lie on the CPU.
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
]

LAG_DEAD_CODE = 3  # 2-bit crumb sentinel of a client that never completes


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
    scheduled ``(S, K)`` rows (slot s lands s + 1 rounds from now).  Returns
    ``(arriving, new_pending)``."""
    shifted = torch.cat([pending[1:], torch.zeros_like(pending[:1])], dim=0)
    return pending[0], shifted + sched


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

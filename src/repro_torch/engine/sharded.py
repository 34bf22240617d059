"""Sort-free ProbAlloc at local placement (the port of the local part of
``repro.engine.sharded``).

The capped allocation solves ``g(alpha) = alpha / sum_j min(w_j, (1 -
sigma) alpha) = 1/(k - K sigma)`` (Eq. 24) by fixed-iteration bisection on
the monotone scalar ``g``; each step needs one ``sum_j min(w_j, cap)``,
taken as the JAX package takes it: per 8192-client tile, then across tiles.
Both branches of the overflow test are computed and ``torch.where`` picks
one, so the allocation never waits on the host.  The mesh (``axis_name``)
and the dyadic block mode (``block > 1``) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.selection.prob_alloc import clip_sigma_one

__all__ = ["masked_prob_alloc", "masked_prob_alloc_scalars"]


def _tiny(dt, device) -> torch.Tensor:
    """Dtype-scaled division guard (float32: ~1e-38)."""
    return torch.full((), torch.finfo(dt).tiny, dtype=dt, device=device)


def _pad_to_tile(x: torch.Tensor, tile: int) -> torch.Tensor:
    pad = (-x.shape[0]) % tile
    return torch.cat([x, x.new_zeros(pad)]) if pad else x


def _tiled_sum(x: torch.Tensor, tile: int) -> torch.Tensor:
    """Two-level (per-tile, then cross-tile) sum of an already tile-padded
    vector: the shape and accuracy of ``repro.engine.sharded._tiled_sum``."""
    return torch.sum(torch.sum(x.reshape(-1, tile), dim=1))


def _alloc_prelude(w, k, sigma, active):
    """Cast to the weight dtype and fold the activity mask into the weights."""
    dt, dev = w.dtype, w.device
    active = torch.ones_like(w) if active is None else active.to(dt)
    return w * active, active, torch.as_tensor(k, dtype=dt, device=dev), torch.as_tensor(sigma, dtype=dt, device=dev)


def _alloc_scalars(w, k, sigma, active, *, n_iters: int, tile: int, block: int):
    """Bracket the cap by bisection; return ``(residual, cap, denom,
    use_cap)`` such that ``p_raw = sigma + residual * min(w, cap) / denom``,
    ``capped = (p_raw >= 1 - 1e-6) & use_cap`` and ``p = clip(p_raw, sigma,
    1) * active`` give the allocation."""
    if block != 1:
        raise NotImplementedError(
            "block > 1 (the dyadic bisect_block_sums kernel) is not ported yet (ROADMAP.md B5, with the mesh)"
        )
    dt, dev = w.dtype, w.device
    eps = _tiny(dt, dev)
    # zero padding is exact: min(0, cap) = 0 for every cap >= 0 the search tries
    w_t, a_t = _pad_to_tile(w, tile), _pad_to_tile(active, tile)
    K_act = _tiled_sum(a_t, tile)
    residual = k - K_act * sigma
    one_ms = 1.0 - sigma

    w_sum = _tiled_sum(w_t, tile)
    w_max = torch.max(torch.where(active > 0, w, torch.full_like(w, float("-inf"))))
    overflow = sigma + residual * w_max / torch.maximum(w_sum, eps) > 1.0 + 1e-9

    lo, hi = torch.zeros((), dtype=dt, device=dev), w_sum / torch.maximum(residual, eps)
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        s = _tiled_sum(torch.minimum(w_t, one_ms * mid), tile)
        go_up = mid * residual < s  # g(mid) < 1/residual: alpha too small
        lo, hi = torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)
    alpha = 0.5 * (lo + hi)
    cap_c = one_ms * alpha
    denom_c = torch.maximum(_tiled_sum(torch.minimum(w_t, cap_c), tile), eps)

    cap = torch.where(overflow, cap_c, torch.full((), float("inf"), dtype=dt, device=dev))
    denom = torch.where(overflow, denom_c, torch.maximum(w_sum, eps))
    return residual, cap, denom, overflow


def masked_prob_alloc(w, k, sigma, active=None, n_iters: int = 48, tile: int = 8192, block: int = 1):
    """Sort-free ProbAlloc (paper Algorithm 2) over an optionally masked
    population: ``(p, capped)`` with ``sum(p) = k``, ``sigma <= p_i <= 1`` on
    active arms and ``p_i = 0`` off them."""
    w, active, k, sigma = _alloc_prelude(w, k, sigma, active)
    residual, cap, denom, use_cap = _alloc_scalars(w, k, sigma, active, n_iters=n_iters, tile=tile, block=block)
    p = sigma + residual * torch.minimum(w, cap) / denom
    capped = (p >= 1.0 - 1e-6) & use_cap
    p = clip_sigma_one(p, sigma) * active
    return p, capped & (active > 0)


def masked_prob_alloc_scalars(w, k, sigma, active=None, n_iters: int = 48, tile: int = 8192, block: int = 1):
    """``masked_prob_alloc`` minus its elementwise epilogue: ``(residual,
    cap, denom, use_cap)`` for the fused select kernel."""
    w, active, k, sigma = _alloc_prelude(w, k, sigma, active)
    return _alloc_scalars(w, k, sigma, active, n_iters=n_iters, tile=tile, block=block)

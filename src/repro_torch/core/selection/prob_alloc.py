"""Probability allocation with overflow capping (paper Algorithm 2), the
sorted case search of Eq. 24 (``allocator="sort"``).

    p_i = sigma + (k - K*sigma) * w'_i / sum_j w'_j            (Eq. 19)

with ``w'_i = min(w_i, (1 - sigma) * alpha)`` and ``alpha`` the largest
value that keeps every ``p_i <= 1``.  Both branches are computed and
``torch.where`` picks one, so the allocation never waits on the host.
``prob_alloc_reference`` is the paper's literal case enumeration in float64
numpy, the test oracle.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["prob_alloc", "prob_alloc_reference"]

_EPS = 1e-12


def _alpha_search(w: torch.Tensor, k: float, K: int, sigma: torch.Tensor) -> torch.Tensor:
    """Solve ``alpha / sum_j min(w_j, (1-sigma) alpha) = 1/(k - K sigma)``
    over all K cases at once (sort + cumulative sums)."""
    dt, dev = w.dtype, w.device
    one_minus_sigma = 1.0 - sigma
    w_sorted = torch.sort(w).values
    psi = w_sorted / torch.clamp(one_minus_sigma, min=_EPS)
    csum = torch.cumsum(w_sorted, 0)
    K_ = torch.full((), K, dtype=dt, device=dev)
    v = torch.arange(K, dtype=dt, device=dev)
    denom = (k - K_ * sigma) - (K_ - 1.0 - v) * one_minus_sigma
    alpha_v = csum / torch.where(torch.abs(denom) < _EPS, torch.full((), _EPS, dtype=dt, device=dev), denom)
    psi_next = torch.cat([psi[1:], torch.full((1,), float("inf"), dtype=dt, device=dev)])
    tol = 1e-5
    valid = (denom > _EPS) & (alpha_v >= psi * (1 - tol) - 1e-9) & (alpha_v < psi_next * (1 + tol) + 1e-9)
    alpha = torch.max(torch.where(valid, alpha_v, torch.full((), float("-inf"), dtype=dt, device=dev)))
    fallback = torch.min(w) / torch.clamp(one_minus_sigma, min=_EPS)
    return torch.where(torch.isfinite(alpha), alpha, fallback)


def prob_alloc(w: torch.Tensor, k: int, sigma: torch.Tensor):
    """Paper Algorithm 2: ``(p, capped)`` with ``sum(p) = k``,
    ``sigma <= p_i <= 1`` and ``capped`` the overflow set ``S_t``."""
    K = w.shape[0]
    dt = w.dtype
    sigma = torch.as_tensor(sigma, dtype=dt, device=w.device)
    residual = torch.full((), k, dtype=dt, device=w.device) - K * sigma

    w_sum = torch.sum(w)
    p_plain = sigma + residual * w / torch.clamp(w_sum, min=_EPS)
    overflow = torch.max(p_plain) > 1.0 + 1e-9

    alpha = _alpha_search(w, float(k), K, sigma)
    cap = (1.0 - sigma) * alpha
    w_c = torch.minimum(w, cap)
    p_cap = sigma + residual * w_c / torch.clamp(torch.sum(w_c), min=_EPS)

    p = torch.where(overflow, p_cap, p_plain)
    capped = overflow & (p_cap >= 1.0 - 1e-6)
    return clip_sigma_one(p, sigma), capped


def clip_sigma_one(p: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(p, sigma, 1)``: ``min(max(p, sigma), 1)``."""
    return torch.clamp(torch.maximum(p, sigma), max=1.0)


def prob_alloc_reference(w, k: int, sigma: float):
    """Brute-force iterative reference (the paper's literal case enumeration)
    in float64 numpy: ``(p, capped)`` as numpy arrays."""
    w = np.asarray(w, dtype=np.float64)
    K = w.shape[0]
    residual = k - K * sigma
    p = sigma + residual * w / w.sum()
    if p.max() <= 1.0 + 1e-12:
        return p, np.zeros(K, bool)
    # iterate the cases of Eq. (24)
    order = np.argsort(w)
    ws = w[order]
    psi = ws / max(1.0 - sigma, _EPS)
    best_alpha = None
    tol = 1e-5
    for v in range(K):
        denom = residual - (K - 1 - v) * (1.0 - sigma)
        if denom <= _EPS:
            continue
        alpha = ws[: v + 1].sum() / denom
        hi = psi[v + 1] if v + 1 < K else np.inf
        if psi[v] * (1 - tol) - 1e-9 <= alpha < hi * (1 + tol) + 1e-9:
            best_alpha = alpha if best_alpha is None else max(best_alpha, alpha)
    if best_alpha is None:
        # degenerate ties at sigma -> k/K: fall back to Claim 1's witness
        best_alpha = float(ws.min()) / max(1.0 - sigma, _EPS)
    cap = (1.0 - sigma) * best_alpha
    w_c = np.minimum(w, cap)
    p = sigma + residual * w_c / w_c.sum()
    return p, p >= 1.0 - 1e-6

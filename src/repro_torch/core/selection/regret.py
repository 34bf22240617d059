"""Hindsight-optimal CEP and regret (paper Definitions 1-2, Theorem 1), the
port of ``repro.core.selection.regret`` (numpy, copied).

The comparator of Definition 1 allocates, in addition to the fairness floor
``sigma_t`` handed to everyone, the residual probability mass ``k - K sigma_t``
through a quota vector ``q*`` with ``sum_i q*_i = 1`` (Fact 7) and
``q*_i (k - K sigma_t) <= 1 - sigma_t`` (Fact 9, i.e. p* <= 1).

Two comparator flavours are provided:

* ``static``    — the best *fixed* quota vector over the horizon (this is the
  comparator the Appendix-A telescoping argument actually supports, as in
  canonical Exp3);
* ``per_round`` — the stronger per-round optimum (upper bound on any static
  comparator; useful as a stress test — E3CS need not beat it, but Theorem 1
  is checked against ``static``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["oracle_cep", "empirical_expected_cep", "regret"]


def oracle_cep(xs: np.ndarray, k: int, sigmas: np.ndarray, mode: str = "static") -> float:
    """E[CEP*_T] per Eq. (26).

    Args:
      xs: (T, K) success bits.
      sigmas: (T,) fairness quotas.
    """
    xs = np.asarray(xs, np.float64)
    T, K = xs.shape
    sigmas = np.broadcast_to(np.asarray(sigmas, np.float64), (T,))
    residual = k - K * sigmas  # (T,)
    floor = float(np.sum(sigmas[:, None] * xs))  # sigma_t * n1_t summed

    if mode == "per_round":
        n1 = xs.sum(1)  # (T,)
        gain = np.minimum(residual, n1 * (1.0 - sigmas))
        return float(np.sum(gain)) + floor

    if mode == "static":
        # maximize sum_i q_i * s_i  s.t. sum q = 1, 0 <= q_i <= cap
        s = (residual[:, None] * xs).sum(0)  # (K,) value of unit quota on arm i
        with np.errstate(divide="ignore"):
            caps_t = np.where(residual > 1e-12, (1.0 - sigmas) / residual, np.inf)
        cap = float(np.min(caps_t)) if len(caps_t) else 1.0
        cap = min(cap, 1.0)
        order = np.argsort(-s)
        q = np.zeros(K)
        mass = 1.0
        for i in order:
            take = min(cap, mass)
            q[i] = take
            mass -= take
            if mass <= 1e-15:
                break
        return float(np.dot(q, s)) + floor

    raise ValueError(mode)


def empirical_expected_cep(ps: np.ndarray, xs: np.ndarray) -> float:
    """E[CEP^alg] = sum_t sum_i p_{i,t} x_{i,t} (Definition 2)."""
    return float(np.sum(np.asarray(ps, np.float64) * np.asarray(xs, np.float64)))


def regret(ps: np.ndarray, xs: np.ndarray, k: int, sigmas, mode: str = "static") -> float:
    return oracle_cep(xs, k, np.asarray(sigmas), mode) - empirical_expected_cep(ps, xs)

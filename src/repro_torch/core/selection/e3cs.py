"""E3CS, Exp3-based client selection (paper Algorithm 1).

    state = e3cs_init(K, device)
    p, capped = e3cs_probs(state, k, sigma_t)          # Algorithm 2
    state = e3cs_update(state, p, capped, sel_mask, x, k, sigma_t, eta)

Weights live in log space and are re-centred after every update (ProbAlloc
is invariant to a common shift).  The operations and their order are those
of ``repro.core.selection.e3cs``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .prob_alloc import prob_alloc

__all__ = ["E3CSState", "e3cs_init", "e3cs_probs", "e3cs_update", "divide", "residual_mass"]


def divide(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n`` rounded once.  On CUDA, PyTorch turns division by a Python
    number into multiplication by its reciprocal, which can differ in the
    last bit; a 0-d tensor divisor on the same device keeps true division,
    as the CPU, XLA and the port's kernels compute it."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def residual_mass(k: int, K: int, sigma: torch.Tensor) -> torch.Tensor:
    """``k - K * sigma``: the probability mass left after the fairness floor."""
    return torch.full((), k, dtype=sigma.dtype, device=sigma.device) - K * sigma


class E3CSState(NamedTuple):
    logw: torch.Tensor  # (K,) log exponential weights
    t: torch.Tensor  # int32 0-d round counter


def e3cs_init(K: int, device=None, dtype=torch.float32) -> E3CSState:
    return E3CSState(
        logw=torch.zeros(K, dtype=dtype, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device),
    )


def e3cs_probs(state: E3CSState, k: int, sigma: torch.Tensor):
    """Probability allocation for the current round (Algorithm 2)."""
    w = torch.exp(state.logw - torch.max(state.logw))
    return prob_alloc(w, k, sigma)


def e3cs_update(
    state: E3CSState, p, capped, sel_mask, x, k: int, sigma, eta: float, K=None, mesh=None, active=None
) -> E3CSState:
    """Exponential-weight update, Eqs. (16)-(17): clamped importance-weighted
    step, capped (and inactive) arms frozen, then re-centred to max 0.

    On one shard of a K-sharded population ``K`` is the global population,
    ``mesh`` (a ``repro_torch.launch.mesh.HostMesh``, where the JAX package
    names an ``axis_name``) takes the re-centring max over the shards, and
    ``active`` marks the shard's padding, which stays frozen at 0."""
    Kt = p.shape[0] if K is None else K
    xhat = sel_mask * x / torch.clamp(p, min=1e-12)  # Eq. (16)
    residual = residual_mass(k, Kt, sigma)
    step = divide(residual * eta * xhat, Kt)  # Eq. (17) exponent
    step = torch.clamp(step, max=1.0)  # the regret proof's Taylor regime
    frozen = capped if active is None else capped | (active == 0)
    logw = state.logw + torch.where(frozen, torch.zeros_like(step), step)
    if active is None:
        m = torch.max(logw)
    else:
        m = torch.max(torch.where(active > 0, logw, torch.full_like(logw, float("-inf"))))
    if mesh is not None:
        m = mesh.pmax(m)
    logw = logw - m
    if active is not None:
        logw = logw * active
    return E3CSState(logw=logw, t=state.t + 1)

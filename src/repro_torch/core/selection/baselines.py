"""Baseline client-selection schemes evaluated in the paper (§VI-A2), the
port of ``repro.core.selection.baselines``.

* ``random``: vanilla FedAvg selection, a uniform k-subset.
* ``fedcs``: prophetic greedy FedCS, the k clients of highest true success
  rate (ties broken by a ``1e-6``-scaled uniform row, then by index).
* ``pow_d``: power-of-choice, a uniform candidate set of ``d`` clients and
  the k of largest reported loss among them.
* ``ucb``: UCB1 on the empirical success rate, a deterministic top-k.

Noise is fed as tensors: ``random_select`` and ``pow_d_select`` take a
permutation row (``jax.random.permutation``'s draw), ``fedcs_select`` a
uniform row.  The client-wide top-k of FedCS and UCB runs through
``sampling.exact_top_k`` (``lax.top_k``'s order: ties by lowest index).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device

from .sampling import exact_top_k, selection_mask, top_k

__all__ = [
    "random_select",
    "fedcs_select",
    "PowDState",
    "pow_d_select",
    "UCBState",
    "ucb_init",
    "ucb_select",
    "ucb_update",
]

_f32 = torch.float32


def random_select(perm: torch.Tensor, K: int, k: int) -> torch.Tensor:
    """Uniform k-subset (the paper's ``Random``): the first k of a
    permutation of the K clients."""
    return perm[:k].to(torch.int32)


def fedcs_select(success_rate: torch.Tensor, k: int, u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prophetic FedCS: top-k by true success rate, ``1e-6 * u`` added when
    a uniform row ``u`` is given."""
    score = success_rate
    if u is not None:
        score = score + torch.full((), 1e-6, dtype=_f32, device=u.device) * u
    return exact_top_k(score, k)[1]


class PowDState(NamedTuple):
    local_loss: torch.Tensor  # (K,) last observed local loss per client


def pow_d_select(perm: torch.Tensor, local_loss: torch.Tensor, k: int, d: int) -> torch.Tensor:
    """Power-of-choice: the first ``d`` of a permutation as the candidate
    set, the k of largest loss among them (ties by candidate position)."""
    if k > d:
        raise ValueError(f"pow_d selects k={k} of d={d} candidates; need k <= d")
    cand = perm[:d]
    _, pos = top_k(local_loss[cand], k)
    return cand[pos.long()].to(torch.int32)


class UCBState(NamedTuple):
    succ: torch.Tensor  # (K,) cumulative observed successes
    pulls: torch.Tensor  # (K,) pull counts
    t: torch.Tensor  # int32 0-d


def ucb_init(K: int, device=None) -> UCBState:
    """No pulls yet, on ``device`` (``None``: CUDA, which raises without it)."""
    device = resolve_device(device)
    return UCBState(torch.zeros(K, dtype=_f32, device=device), torch.zeros(K, dtype=_f32, device=device),
                    torch.zeros((), dtype=torch.int32, device=device))


def ucb_select(state: UCBState, k: int) -> torch.Tensor:
    """Top-k of ``mean + sqrt(2 log(t + 1) / pulls)``, ``+inf`` for a client
    never pulled."""
    one = torch.ones((), dtype=_f32, device=state.succ.device)
    t = torch.maximum(state.t.to(_f32), one)
    pulls = torch.maximum(state.pulls, one)
    mean = state.succ / pulls
    bonus = torch.sqrt(2.0 * torch.log(t + 1.0) / pulls)
    score = torch.where(state.pulls == 0, torch.full_like(mean, float("inf")), mean + bonus)
    return exact_top_k(score, k)[1]


def ucb_update(state: UCBState, idx: torch.Tensor, x: torch.Tensor) -> UCBState:
    mask = selection_mask(idx, state.succ.shape[0])
    return UCBState(succ=state.succ + mask * x, pulls=state.pulls + mask, t=state.t + 1)

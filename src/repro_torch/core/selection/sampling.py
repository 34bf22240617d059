"""Sampling ``k`` clients without replacement from a probability allocation.

The paper's ``multinomialNR(p/k, k)`` draw is the Plackett-Luce law over
k-prefixes; the Gumbel top-k trick gives it in one pass: perturb ``log p``
with iid Gumbel(0, 1) noise and take the top k.  The port takes the Gumbel
row as a tensor (``g``), so the staged and the fused round, and a test that
feeds the JAX package's own draw, all consume the same noise.
"""
from __future__ import annotations

import torch

__all__ = ["perturbed_scores", "top_k", "plackett_luce_sample", "selection_mask", "gumbel_row"]

_EPS = 1e-20


def gumbel_row(generator: torch.Generator, K: int, device) -> torch.Tensor:
    """One ``(K,)`` float32 Gumbel(0, 1) row, ``-log(-log(u))`` with ``u``
    uniform in ``[tiny, 1)``."""
    u = torch.rand(K, generator=generator, device=device, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def perturbed_scores(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The Plackett-Luce score field ``log p + g``."""
    return torch.log(torch.clamp(p, min=_EPS)) + g


def top_k(scores: torch.Tensor, k: int):
    """``lax.top_k`` order: value descending, ties by index ascending (a
    stable sort of ``-scores``).  Returns ``(values, int32 indices)``."""
    order = torch.sort(-scores, stable=True).indices[:k]
    return scores[order], order.to(torch.int32)


def plackett_luce_sample(g: torch.Tensor, p: torch.Tensor, k: int) -> torch.Tensor:
    """Gumbel top-k == multinomial sampling without replacement; ``(k,)``
    int32 indices of the selected clients."""
    return top_k(perturbed_scores(g, p), k)[1]


def selection_mask(idx: torch.Tensor, K: int) -> torch.Tensor:
    """``(K,)`` float32 mask with ones at the selected indices."""
    return torch.zeros(K, dtype=torch.float32, device=idx.device).index_fill_(0, idx.long(), 1.0)

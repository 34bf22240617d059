"""Sampling ``k`` clients without replacement from a probability allocation.

The paper's ``multinomialNR(p/k, k)`` draw is the Plackett-Luce law over
k-prefixes; the Gumbel top-k trick gives it in one pass: perturb ``log p``
with iid Gumbel(0, 1) noise and take the top k.  The port takes the Gumbel
row as a tensor (``g``), so the staged and the fused round, and a test that
feeds the JAX package's own draw, all consume the same noise.
"""
from __future__ import annotations

import torch

__all__ = [
    "perturbed_scores",
    "top_k",
    "plackett_luce_sample",
    "local_topk_candidates",
    "merge_topk_candidates",
    "selection_mask",
    "gumbel_row",
    "gumbel_from_uniform",
    "uniform_row",
]

_EPS = 1e-20


def gumbel_row(generator: torch.Generator, K: int, device) -> torch.Tensor:
    """One ``(K,)`` float32 Gumbel(0, 1) row, ``-log(-log(u))`` with ``u``
    uniform in ``[tiny, 1)``."""
    return gumbel_from_uniform(torch.rand(K, generator=generator, device=device, dtype=torch.float32))


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """The Gumbel transform of ``gumbel_row`` applied to a uniform row drawn
    beforehand (the captured round step draws its rows outside the graph)."""
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def uniform_row(generator: torch.Generator, K: int, device) -> torch.Tensor:
    """One ``(K,)`` float32 Uniform[0, 1) row: the noise the fused Gumbel
    top-k perturbs in registers."""
    return torch.rand(K, generator=generator, device=device, dtype=torch.float32)


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


def local_topk_candidates(scores: torch.Tensor, k: int, offset: int):
    """One shard's top-k candidates ``(values, global int32 indices)`` for a
    distributed top-k: the local ``top_k`` plus the shard's global offset."""
    v, i = top_k(scores, k)
    return v, i + int(offset)


def merge_topk_candidates(vals: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """The exact global top-k indices from the D shards' candidates, flattened
    in shard order, each shard's list sorted as ``top_k`` emits it.

    Containment: a member of the global top-k has fewer than k scores above
    it anywhere, so fewer than k in its own shard, and is among that shard's
    candidates; one ``top_k`` over the ``D*k`` candidates finds it.  Ties
    resolve to the lowest index, as a dense ``top_k`` does: shards cover
    contiguous index ranges in order, and each list emits equal values in
    index order.
    """
    _, pos = top_k(vals.reshape(-1), k)
    return idx.reshape(-1)[pos.long()].to(torch.int32)


def selection_mask(idx: torch.Tensor, K: int) -> torch.Tensor:
    """``(K,)`` float32 mask with ones at the selected indices."""
    return torch.zeros(K, dtype=torch.float32, device=idx.device).index_fill_(0, idx.long(), 1.0)

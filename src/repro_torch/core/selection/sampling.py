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
    "exact_top_k",
    "systematic_sample",
    "sample_selection",
    "inclusion_probability_mc",
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


def exact_top_k(scores: torch.Tensor, k: int):
    """``top_k`` of a client-wide ``(K,)`` float32 row through the exact
    top-k kernel's wrapper (``kernels.gumbel_topk_kernel_call``: the kernel
    on a CUDA tensor, its plain version, ``top_k``, on a CPU one), or
    ``top_k`` itself when ``k`` exceeds what the kernel ranks.  A ``(J,
    K)`` batch is ranked a row at a time, each row as a ``(K,)`` row is."""
    from repro_torch.kernels.gumbel_topk import MAX_K, gumbel_topk_kernel_call  # the kernels import this module

    if scores.dim() > 1:
        vals, idx = zip(*(exact_top_k(row, k) for row in scores))
        return torch.stack(vals), torch.stack(idx)
    if k <= MAX_K:
        return gumbel_topk_kernel_call(scores, k)
    return top_k(scores, k)


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


_SCAN_ROW = 1024  # clients a row of the blocked cumulative sum


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """The float32 inclusive cumulative sum of a ``(K,)`` row, the same bits
    at every call.  On the CPU: ``torch.cumsum``, in order (as the JAX
    package sums on the CPU).  On CUDA ``torch.cumsum`` of a 1-D tensor is a
    single-pass scan whose partial sums combine in an order that varies from
    call to call; the row is cut into rows of ``_SCAN_ROW`` clients, each
    scanned by one block in a fixed order (a 2-D scan along its last axis),
    and the rows' exclusive prefix, scanned the same way, added to them."""
    if x.device.type == "cpu":
        return torch.cumsum(x, dim=0)
    K = x.shape[0]
    R = max(2, -(-K // _SCAN_ROW))  # at least two rows: one row would take the 1-D scan
    within = torch.cumsum(torch.cat([x, x.new_zeros(R * _SCAN_ROW - K)]).reshape(R, _SCAN_ROW), dim=1)
    totals = within[:, -1]
    prefix = torch.cumsum(torch.stack([totals, totals]), dim=1)[0]  # (2, R): the 2-D scan again
    before = torch.cat([x.new_zeros(1), prefix[:-1]])
    return (within + before[:, None]).reshape(-1)[:K]


def systematic_sample(perm: torch.Tensor, u: torch.Tensor, p: torch.Tensor, k: int) -> torch.Tensor:
    """Madow's systematic sampling: exact inclusion probabilities.

    With ``sum(p) = k`` and ``0 <= p_i <= 1``: permute the clients by
    ``perm`` (so joint inclusions do not follow client order), then select
    every client whose cumulative interval ``[C_{i-1}, C_i)`` holds one of
    the points ``u, u+1, ..., u+k-1`` (``u`` a 0-d uniform).  No client is
    hit twice, so k distinct clients are chosen, in permuted order.
    """
    K = p.shape[0]
    p_perm = p[perm]
    c = _cumsum(p_perm)
    c0 = torch.cat([torch.zeros(1, dtype=p.dtype, device=p.device), c[:-1]])
    hits = torch.floor(c - u) - torch.floor(c0 - u)
    score = (hits >= 1.0).to(p.dtype) * (K - torch.arange(K, dtype=p.dtype, device=p.device))
    _, pos = exact_top_k(score, k)
    return perm[pos.long()].to(torch.int32)


def sample_selection(noise, p: torch.Tensor, k: int, method: str = "plackett_luce") -> torch.Tensor:
    """The cohort from ``p`` by ``method``: ``plackett_luce`` takes the
    Gumbel row ``noise.g``, ``systematic`` the permutation ``noise.perm``
    and the 0-d uniform ``noise.v``."""
    if method == "plackett_luce":
        return plackett_luce_sample(noise.g, p, k)
    if method == "systematic":
        return systematic_sample(noise.perm, noise.v, p, k)
    raise ValueError(f"unknown sampling method: {method!r}")


def inclusion_probability_mc(generator: torch.Generator, p: torch.Tensor, k: int, n: int, method: str) -> torch.Tensor:
    """Monte-Carlo estimate of inclusion probabilities: the mean selection
    mask of ``n`` draws, their noise from ``generator``."""
    from types import SimpleNamespace

    K, dev = p.shape[0], p.device
    total = torch.zeros(K, dtype=torch.float32, device=dev)
    for _ in range(n):
        if method == "plackett_luce":
            noise = SimpleNamespace(g=gumbel_row(generator, K, dev))
        else:
            perm = torch.randperm(K, generator=generator, device=dev)
            noise = SimpleNamespace(perm=perm, v=torch.rand((), generator=generator, device=dev))
        total += selection_mask(sample_selection(noise, p, k, method), K)
    return total / n

"""Fairness and participation metrics on tensors (the port of
``repro.core.fairness``): Jain's index, normalised selection entropy, Gini,
the top share, CEP (Eq. 8) and the success ratio (Fig. 4), in float32 as
the JAX package computes them; ``class_selection_stats`` in numpy."""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "jain_index", "selection_entropy", "gini", "top_share",
    "cep", "success_ratio", "class_selection_stats",
]

_f32 = torch.float32


def _c(v, like) -> torch.Tensor:
    return torch.full((), v, dtype=_f32, device=like.device)


def jain_index(counts) -> torch.Tensor:
    """Jain's fairness index in (1/K, 1]; 1 == perfectly even."""
    counts = torch.as_tensor(counts).to(_f32)
    num = torch.sum(counts) ** 2
    den = counts.shape[0] * torch.sum(counts ** 2)
    return num / torch.maximum(den, _c(1e-12, counts))


def selection_entropy(counts) -> torch.Tensor:
    """Entropy of the empirical selection distribution, normalised to [0, 1]."""
    counts = torch.as_tensor(counts).to(_f32)
    p = counts / torch.maximum(torch.sum(counts), _c(1e-12, counts))
    h = -torch.sum(torch.where(p > 0, p * torch.log(p), torch.zeros_like(p)))
    return h / torch.log(_c(counts.shape[0], counts))


def gini(counts) -> torch.Tensor:
    """Exact Gini coefficient of selection counts in [0, 1); 0 == even:
    ``2 * sum_i i * c_(i) / (K * sum c) - (K + 1) / K`` over the ascending
    counts."""
    c = torch.sort(torch.as_tensor(counts).to(_f32)).values
    K = c.shape[0]
    total = torch.maximum(torch.sum(c), _c(1e-12, c))
    ranks = torch.arange(1, K + 1, dtype=_f32, device=c.device)
    return 2.0 * torch.dot(ranks, c) / (K * total) - _c((K + 1.0) / K, c)


def top_share(counts, frac: float = 0.1) -> torch.Tensor:
    """Selection-mass share of the most-selected ``frac`` of clients."""
    c = torch.flip(torch.sort(torch.as_tensor(counts).to(_f32)).values, dims=(0,))
    K = c.shape[0]
    take = torch.clamp(_c(frac * K, c) - torch.arange(K, dtype=_f32, device=c.device), 0.0, 1.0)
    return torch.dot(take, c) / torch.maximum(torch.sum(c), _c(1e-12, c))


def cep(sel_masks, xs) -> torch.Tensor:
    """Cumulative effective participation: sum_t sum_{i in A_t} x_{i,t}."""
    return torch.sum(torch.as_tensor(sel_masks) * torch.as_tensor(xs))


def success_ratio(sel_masks, xs) -> torch.Tensor:
    """CEP / (T*k) as in Fig. 4 (top)."""
    m = torch.as_tensor(sel_masks)
    return cep(m, xs) / torch.maximum(torch.sum(m), _c(1e-12, m))


def class_selection_stats(counts, class_sizes):
    """Per-class selection-count summaries (Fig. 3's box plots): for
    clients ordered by class with ``class_sizes`` members each, a dict of
    min / q1 / median / q3 / max / mean per class."""
    counts = np.asarray(counts.cpu() if torch.is_tensor(counts) else counts)
    out, off = [], 0
    for n in class_sizes:
        c = np.sort(counts[off : off + n])
        off += n
        out.append(
            dict(
                min=float(c.min()),
                q1=float(np.percentile(c, 25)),
                median=float(np.percentile(c, 50)),
                q3=float(np.percentile(c, 75)),
                max=float(c.max()),
                mean=float(c.mean()),
            )
        )
    return out

"""Client data partitioning (paper §VI-A "Simulation of data distribution").

* iid: each client samples |D_i| examples uniformly.
* primary-label non-iid (the paper's scheme): each client gets one primary
  label; 80% of its data carries that label, 20% is drawn from the rest.
* Dirichlet(alpha) non-iid (beyond paper; standard FL benchmark knob).

Each client reserves 10% of its shard for local testing, as in the paper.
Numpy, a copy of ``repro.data.partition``.
"""
from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["partition_iid", "partition_primary_label", "partition_dirichlet", "split_local_test"]


def partition_iid(y: np.ndarray, K: int, per_client: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.choice(len(y), per_client, replace=True) for _ in range(K)]


def partition_primary_label(
    y: np.ndarray, K: int, per_client: int, primary_frac: float = 0.8, seed: int = 0
) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    by_class = {c: np.where(y == c)[0] for c in classes}
    rest = np.arange(len(y))
    out = []
    n_primary = int(primary_frac * per_client)
    for i in range(K):
        c = classes[rng.integers(0, len(classes))]
        prim = rng.choice(by_class[c], n_primary, replace=True)
        other_pool = rest[y[rest] != c]
        oth = rng.choice(other_pool, per_client - n_primary, replace=True)
        out.append(np.concatenate([prim, oth]))
    return out


def partition_dirichlet(y: np.ndarray, K: int, per_client: int, alpha: float = 0.3, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    by_class = {c: np.where(y == c)[0] for c in classes}
    out = []
    for i in range(K):
        mix = rng.dirichlet(alpha * np.ones(len(classes)))
        counts = rng.multinomial(per_client, mix)
        idx = [rng.choice(by_class[c], n, replace=True) for c, n in zip(classes, counts) if n > 0]
        out.append(np.concatenate(idx) if idx else np.empty(0, int))
    return out


def split_local_test(indices: List[np.ndarray], test_frac: float = 0.1, seed: int = 0):
    rng = np.random.default_rng(seed)
    train, test = [], []
    for idx in indices:
        perm = rng.permutation(idx)
        n_test = max(1, int(test_frac * len(perm)))
        test.append(perm[:n_test])
        train.append(perm[n_test:])
    return train, test

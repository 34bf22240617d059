"""Batched data pipeline for the FL round (numpy; a copy of
``repro.data.pipeline``, so a store seeded alike serves the JAX package's
batches byte for byte).

Each round needs, for the k selected clients, ``E_i`` epochs of mini-batches
of size ``B``.  The host pre-gathers a dense array of per-client batches —
``(k, n_steps, B, ...)``, images NHWC as the JAX package serves them — and
the round steps through it; variable epoch counts become a step mask.

For LM-scale runs, ``lm_client_batches`` carves a token stream into
per-client contiguous shards (heterogeneous bigram mixtures make them
non-iid) and emits (k, n_steps, B, S) token blocks.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["ClientStore", "lm_client_batches"]


class ClientStore:
    """Holds the full dataset + per-client index lists; serves round batches."""

    def __init__(self, data: Dict[str, np.ndarray], client_indices: List[np.ndarray], seed: int = 0):
        self.data = data
        self.clients = client_indices
        self.rng = np.random.default_rng(seed)

    @property
    def K(self) -> int:
        return len(self.clients)

    def sizes(self) -> np.ndarray:
        return np.array([len(c) for c in self.clients], np.float32)

    def round_batches(self, selected: Sequence[int], epochs: np.ndarray, batch_size: int, n_steps: int = 0):
        """Gather (k, n_steps, B, ...) x/y tensors + (k, n_steps) step mask.

        ``n_steps`` defaults to ``max_i epochs_i * ceil(|D_i| / B)`` over the
        cohort; callers pass a fixed upper bound so every round has one
        shape; clients with fewer steps are masked (their trailing steps are
        no-ops in the local update).
        """
        sel = list(selected)
        steps_per_epoch = [max(1, len(self.clients[i]) // batch_size) for i in sel]
        if not n_steps:
            n_steps = max(int(e) * s for e, s in zip(epochs[sel], steps_per_epoch))
        xs, ys, mask = [], [], []
        for i, spe in zip(sel, steps_per_epoch):
            idx = self.clients[i]
            tot = min(int(epochs[i]) * spe, n_steps)
            batches = []
            for e in range(int(epochs[i])):
                perm = self.rng.permutation(idx)[: spe * batch_size]
                batches.append(perm.reshape(spe, batch_size))
            b = np.concatenate(batches, 0)[:tot]  # (tot, B)
            pad = n_steps - tot
            if pad > 0:
                b = np.concatenate([b, np.tile(b[-1:], (pad, 1))], 0)
            xs.append(self.data["x"][b])
            ys.append(self.data["y"][b])
            mask.append(np.concatenate([np.ones(tot), np.zeros(pad)]).astype(np.float32))
        return np.stack(xs), np.stack(ys), np.stack(mask)

    def eval_batch(self, n: int = 2048, test: bool = True):
        x = self.data["x_test" if test else "x"]
        y = self.data["y_test" if test else "y"]
        n = min(n, len(y))
        return x[:n], y[:n]


def lm_client_batches(stream: np.ndarray, K: int, k_sel: Sequence[int], n_steps: int, B: int, S: int, seed: int = 0):
    """(k, n_steps, B, S+1) token blocks from per-client stream shards."""
    rng = np.random.default_rng(seed)
    shard = len(stream) // K
    out = []
    for i in k_sel:
        lo = i * shard
        starts = rng.integers(lo, lo + shard - S - 1, (n_steps, B))
        blk = np.stack([[stream[s : s + S + 1] for s in row] for row in starts])
        out.append(blk)
    return np.stack(out).astype(np.int32)

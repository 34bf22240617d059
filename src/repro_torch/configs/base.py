"""Run configuration: ``FLConfig``, field for field the one in
``repro.configs.base`` (copied, not imported: the port depends on nothing of
``repro``).  ``ModelConfig`` comes with the model zoo."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

__all__ = ["FLConfig"]


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning run config (paper Table I + selection scheme)."""

    K: int = 100  # total clients
    k: int = 20  # cohort size per round
    rounds: int = 400
    scheme: str = "e3cs"  # e3cs | random | fedcs | pow_d | ucb
    quota: str = "const"  # const | inc | linear | cosine
    quota_frac: float = 0.5  # sigma_t = frac * k/K for const
    eta: float = 0.5  # E3CS learning rate
    sampler: str = "plackett_luce"  # plackett_luce | systematic
    allocator: str = "sort"  # sort (paper case-analysis) | bisect (sort-free, shardable)
    pow_d: int = 40  # candidate-set size for pow-d
    # local update (o1)
    local_update: str = "fedavg"  # fedavg | fedprox
    prox_coef: float = 0.5
    local_epochs: Tuple[int, ...] = (1, 2, 3, 4)  # heterogeneous, sampled per client
    batch_size: int = 40
    lr: float = 1e-2
    momentum: float = 0.9
    # aggregation (o2)
    aggregation: str = "fedavg"  # fedavg (data-size weighted) | mean | epoch_weighted
    # async rounds: late-but-alive updates kept for S rounds, credited alpha**lag
    staleness_rounds: int = 0  # S: staleness buffer depth; 0 = sync deadline drop
    staleness_alpha: float = 0.5  # decay per round of lag
    late_prob: float = 0.7  # P(a missed-deadline client still completes)
    lag_decay: float = 0.5  # geometric lag tail: P(one more round) = 1 - lag_decay
    # volatility
    volatility: str = "bernoulli"  # builtin (bernoulli | markov | deadline) or a scenario name
    success_rates: Tuple[float, ...] = (0.1, 0.3, 0.6, 0.9)
    markov_stickiness: float = 0.8
    # data
    samples_per_client: int = 500
    non_iid: bool = True
    primary_frac: float = 0.8
    seed: int = 0

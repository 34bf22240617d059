"""Volatile-client models: generators of the success bits ``x_{i,t}`` and of
completion lags (the port of ``repro.core.volatility``).

A model draws nothing itself.  ``draw(generator)`` returns the tuple of
``(K,)`` uniform rows that one round consumes, and ``sample(us, state)``
turns those rows into outcomes.  The split lets a test feed the JAX
package's own uniforms into ``sample`` and compare outcomes exactly, while
the engine draws the rows from one explicit ``torch.Generator`` on the
device.  ``draw_bounds()`` gives each row's lower end ``lo``: ``draw`` is
``uniform_rows`` of one ``torch.rand`` row each, so a runner that draws the
raw rows itself (into the buffers of a captured round step) scales them
with the same operations.

Lag protocol (async rounds): ``sample`` returns an int32 ``(K,)`` lag row,
``0`` = on time, ``l >= 1`` = ``l`` rounds late, ``DEAD_LAG`` = never.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "DEAD_LAG",
    "paper_success_rates",
    "make_volatility",
    "BernoulliVolatility",
    "CompletionLag",
    "uniform_rows",
]

DEAD_LAG = -1  # lag value of a client that never completes


def paper_success_rates(K: int, rates=(0.1, 0.3, 0.6, 0.9), remainder: str = "stable") -> np.ndarray:
    """Paper §VI-A: equal split of K clients into ``len(rates)`` classes,
    contiguous by class.  ``remainder="stable"`` puts the leftover clients in
    the most stable class, ``"spread"`` gives class sizes that differ by at
    most one, extras from the least stable class upward."""
    per, rem = divmod(K, len(rates))
    if remainder == "stable":
        counts = [per] * len(rates)
        counts[-1] += rem
    elif remainder == "spread":
        counts = [per + (1 if i < rem else 0) for i in range(len(rates))]
    else:
        raise ValueError(f"unknown remainder policy {remainder!r} (want 'stable' or 'spread')")
    out = np.concatenate([np.full(n, r) for n, r in zip(counts, rates)])
    return out.astype(np.float32)


def make_volatility(name: str, rho, *, device=None):
    """Construct a named volatility model over success rates ``rho`` (K,).
    Only ``bernoulli`` is ported; ``markov`` and ``deadline`` raise."""
    if name == "bernoulli":
        return BernoulliVolatility(torch.as_tensor(np.asarray(rho), dtype=torch.float32, device=device))
    if name in ("markov", "deadline"):
        raise NotImplementedError(
            f"volatility model {name!r} is not ported yet (ROADMAP.md A3: Markov/Deadline volatility)"
        )
    raise ValueError(f"unknown volatility model {name!r} (want bernoulli | markov | deadline)")


def _scale_row(u: torch.Tensor, lo: float) -> torch.Tensor:
    """A ``[0, 1)`` row moved to ``[lo, 1)``, as ``jax.random.uniform(
    minval=lo, maxval=1)`` scales its ``[0, 1)`` draw."""
    if lo:
        lo_t = torch.full((), lo, dtype=torch.float32, device=u.device)
        u = torch.maximum(u * (1.0 - lo_t) + lo_t, lo_t)
    return u


def uniform_rows(raw, bounds) -> Tuple[torch.Tensor, ...]:
    """A model's rows from raw ``[0, 1)`` rows and its ``draw_bounds()``."""
    return tuple(_scale_row(u, lo) for u, lo in zip(raw, bounds))


def _draw(model, generator: torch.Generator) -> Tuple[torch.Tensor, ...]:
    K, dev = model.rho.shape[0], model.rho.device
    raw = [torch.rand(K, generator=generator, device=dev, dtype=torch.float32) for _ in model.draw_bounds()]
    return uniform_rows(raw, model.draw_bounds())


@dataclass(frozen=True)
class BernoulliVolatility:
    """iid per-round success bits, ``x_{i,t} ~ Bern(rho_i)``: one uniform
    row, ``x = u < rho`` (``jax.random.bernoulli``'s comparison)."""

    rho: torch.Tensor  # (K,) float32

    def init_state(self):
        return torch.zeros_like(self.rho)

    def draw_bounds(self) -> Tuple[float, ...]:
        return (0.0,)

    def draw(self, generator: torch.Generator) -> Tuple[torch.Tensor, ...]:
        return _draw(self, generator)

    def sample(self, us, state):
        return (us[0] < self.rho).to(torch.float32), state

    def to(self, device):
        return dataclasses.replace(self, rho=self.rho.to(device))


@dataclass(frozen=True)
class CompletionLag:
    """Completion-lag draw over a success-bit model.

    ``base`` decides who finishes on time (lag 0).  A client that misses the
    deadline still completes with probability ``p_late``, after ``1 +
    Geometric(lag_decay)`` rounds truncated at ``max_lag``; otherwise it is
    ``DEAD_LAG``.  Consumes the base model's rows, then a late row and a lag
    row in ``[1e-7, 1)``.
    """

    base: object
    p_late: float = 0.7
    lag_decay: float = 0.5  # P(one more round late) = 1 - lag_decay
    max_lag: int = 4

    @property
    def rho(self):
        return getattr(self.base, "rho", None)

    def init_state(self):
        return self.base.init_state()

    def draw_bounds(self) -> Tuple[float, ...]:
        return self.base.draw_bounds() + (0.0, 1e-7)

    def draw(self, generator: torch.Generator) -> Tuple[torch.Tensor, ...]:
        return _draw(self, generator)

    def sample(self, us, state):
        *u_base, u_late, u_lag = us
        x, vs = self.base.sample(tuple(u_base), state)
        late = u_late < torch.full((), self.p_late, dtype=torch.float32, device=u_late.device)
        denom = torch.log1p(torch.full((), -min(self.lag_decay, 1.0 - 1e-7), dtype=torch.float32, device=u_lag.device))
        extra = torch.floor(torch.log(u_lag) / denom).to(torch.int32)
        lag_late = 1 + torch.clamp(extra, 0, self.max_lag - 1)
        dead = torch.full_like(lag_late, DEAD_LAG)
        lag = torch.where(x > 0, torch.zeros_like(lag_late), torch.where(late, lag_late, dead))
        return lag.to(torch.int32), vs

    def to(self, device):
        return dataclasses.replace(self, base=self.base.to(device))

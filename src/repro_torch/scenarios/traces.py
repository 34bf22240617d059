"""Structured volatility: the availability patterns real device fleets show
(the port of ``repro.scenarios.traces``).

Phones charge overnight (diurnal cycles phased by timezone), an outage takes
a whole region down at once (correlated failures), and a viral event brings a
crowd of devices that then churns away.  Each model here is one of those
mechanisms in the draw protocol of ``repro_torch.core.volatility``
(``draw_rows`` / ``draw`` / ``sample(us, state)``), so it drops into the
round program, the captured horizon and the trace recorder unchanged.  Its
state is a tensor or a tuple of tensors, advanced by tensor operations only
(no host branch), so the round step that carries it can be captured.

Every model exposes ``rho``, the base per-client rate the structure
modulates, and ``marginal_rate()``, the long-run marginal an omniscient
baseline (fedcs) is handed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.volatility import _Model, _scalar

__all__ = ["DiurnalVolatility", "RegionalOutageVolatility", "FlashCrowdVolatility"]

_f32 = torch.float32


def _bernoulli(u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.bernoulli``'s comparison of a uniform row with ``p``."""
    return (u < p).to(_f32)


@dataclass(frozen=True)
class DiurnalVolatility(_Model):
    """Timezone-phased sinusoidal availability: ``rho_i(t) = clip(rho_i + A
    sin(2 pi (t / period + phase_i)), lo, hi)``.  The state is the 0-d int32
    round index; one uniform row a round."""

    rho: torch.Tensor  # (K,) base success rates
    phase: torch.Tensor  # (K,) in [0, 1): fraction-of-day offset
    amplitude: float = 0.35
    period: int = 48  # rounds per day
    lo: float = 0.005
    hi: float = 0.995

    def init_state(self):
        return torch.zeros((), dtype=torch.int32, device=self.rho.device)

    def rate(self, t) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=torch.int32, device=self.rho.device).to(_f32)
        ang = _scalar(2.0 * math.pi, self.rho) * (t / _scalar(self.period, self.rho) + self.phase)
        return torch.clamp(self.rho + _scalar(self.amplitude, self.rho) * torch.sin(ang), self.lo, self.hi)

    def marginal_rate(self) -> torch.Tensor:
        return torch.stack([self.rate(t) for t in range(self.period)]).mean(0)

    def draw_rows(self):
        return ((self.rho.shape[0], 0.0),)

    def key_paths(self):
        return ((),)

    def sample(self, us, state):
        return _bernoulli(us[0], self.rate(state)), state + 1


@dataclass(frozen=True)
class RegionalOutageVolatility(_Model):
    """Correlated regional outages: each of ``n_regions`` regions carries a
    2-state up/down chain (up -> down w.p. ``p_fail``, down -> up w.p.
    ``p_recover``); while a client's region is down its rate falls to ``rho
    * (1 - severity)``.  The state is the ``(n_regions,)`` up row (all up at
    the start); two uniform rows a round, ``(n_regions,)`` then ``(K,)``."""

    rho: torch.Tensor  # (K,) base success rates
    region: torch.Tensor  # (K,) int32 region ids in [0, n_regions)
    n_regions: int
    p_fail: float = 0.02
    p_recover: float = 0.25
    severity: float = 0.9

    def init_state(self):
        return torch.ones(self.n_regions, dtype=_f32, device=self.rho.device)

    def availability(self) -> float:
        """Stationary P(region up) of the Gilbert-Elliott chain."""
        return self.p_recover / (self.p_fail + self.p_recover)

    def marginal_rate(self) -> torch.Tensor:
        a = self.availability()
        return self.rho * _scalar(a + (1.0 - a) * (1.0 - self.severity), self.rho)

    def draw_rows(self):
        return ((self.n_regions, 0.0), (self.rho.shape[0], 0.0))

    def key_paths(self):
        return (((0, 2),), ((1, 2),))  # r_reg, r_cli = split(key)

    def sample(self, us, state):
        u_reg, u_cli = us
        p_up = state * _scalar(1.0 - self.p_fail, state) + (1.0 - state) * _scalar(self.p_recover, state)
        up = _bernoulli(u_reg, p_up)
        factor = up[self.region.long()]
        rate = self.rho * (1.0 - _scalar(self.severity, factor) * (1.0 - factor))
        return _bernoulli(u_cli, rate), up


@dataclass(frozen=True)
class FlashCrowdVolatility(_Model):
    """Flash-crowd churn: clients with ``crowd == 1`` sit at ``base_avail``
    outside the window ``[t_start, t_end)``; at ``t_start`` they all arrive
    (availability ``peak``) and each round of the window each leaves for
    good w.p. ``churn``.  Other clients keep their ``rho``.  The state is
    the ``(K,)`` still-present row and the 0-d int32 round index; two
    uniform rows a round (``r_x``, ``r_leave``)."""

    rho: torch.Tensor  # (K,) base rates (used for non-crowd clients)
    crowd: torch.Tensor  # (K,) {0,1} flash-crowd membership
    t_start: int
    t_end: int
    churn: float = 0.05
    base_avail: float = 0.1
    peak: float = 0.95

    def init_state(self):
        return torch.ones_like(self.rho), torch.zeros((), dtype=torch.int32, device=self.rho.device)

    def marginal_rate(self) -> torch.Tensor:
        # crowd clients spend most of a long horizon outside the window
        return torch.where(self.crowd > 0, _scalar(self.base_avail, self.rho), self.rho)

    def draw_rows(self):
        K = self.rho.shape[0]
        return ((K, 0.0), (K, 0.0))

    def key_paths(self):
        return (((0, 2),), ((1, 2),))  # r_x, r_leave = split(key)

    def sample(self, us, state):
        alive, t = state
        u_x, u_leave = us
        in_w = ((t >= self.t_start) & (t < self.t_end)).to(_f32)
        alive = torch.where(t == self.t_start, torch.ones_like(alive), alive)
        peak, base = _scalar(self.peak, alive), _scalar(self.base_avail, alive)
        crowd_rate = in_w * (alive * peak + (1.0 - alive) * base) + (1.0 - in_w) * base
        rate = torch.where(self.crowd > 0, crowd_rate, self.rho)
        x = _bernoulli(u_x, rate)
        leave = _bernoulli(u_leave, torch.full_like(alive, self.churn)) * in_w
        alive = alive * (1.0 - leave)
        return x, (alive, t + 1)

"""Volatile-client models: generators of the success bits ``x_{i,t}`` and of
completion lags (the port of ``repro.core.volatility``).

A model draws nothing itself.  ``draw(rng)`` returns the tuple of uniform
rows that one round consumes (from a ``core.prng.Key``, the rows the JAX
model's ``sample(key, state)`` draws), and ``sample(us, state)`` turns
those rows into outcomes.  The split lets a test feed the JAX package's own
uniforms into ``sample`` and compare outcomes exactly, while the engine
draws the rows on the device from the JAX key stream (or, where a caller
asks for it, one explicit ``torch.Generator``).
``draw_rows()`` gives each row's length ``n`` (or its shape, for a model
over a ``(J, K_max)`` population of J jobs: ``row_shape``) and lower end
``lo``, in the order ``sample`` consumes them (the order ``jax.random.split`` hands the
JAX model its keys): ``draw`` is ``uniform_rows`` of one ``torch.rand`` row
each, so a runner that draws the raw rows itself (into the buffers of a
captured round step) scales them with the same operations.  ``key_paths()``
gives, row by row, the splits that lead from the key JAX hands the model's
``sample`` to the key of that row (``(i, n)`` is ``split(key, n)[i]``, a
step of ``core.prng.derive``), so a runner on the JAX key stream
(``core.prng``) draws the JAX model's rows exactly, in either mode.

Lag protocol (async rounds): ``sample`` returns an int32 ``(K,)`` lag row,
``0`` = on time, ``l >= 1`` = ``l`` rounds late, ``DEAD_LAG`` = never.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "DEAD_LAG",
    "paper_success_rates",
    "calibrate_deadline",
    "make_volatility",
    "BernoulliVolatility",
    "MarkovVolatility",
    "DeadlineVolatility",
    "BinaryLag",
    "CompletionLag",
    "OnTimeBits",
    "uniform_rows",
    "row_shape",
    "model_to",
]

DEAD_LAG = -1  # lag value of a client that never completes
_f32 = torch.float32


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


def calibrate_deadline(rho, epochs, deadline: float, jitter: float):
    """Solve the deadline model for ``(base_time, p_net_fail)`` so the joint
    marginal success probability equals ``rho`` per client.

    Each client's failure rate is split evenly between network faults and
    deadline misses: ``P(ok_net) = 1 - p_net`` with ``p_net = (1 - rho)/2``,
    and ``P(ok_time) = q = rho / (1 - p_net)`` inverts the time model to
    ``base = deadline / (epochs * (1 - jitter * log(1 - q)))``.  Float64
    numpy arrays (callers cast to float32 at model construction).
    """
    rho64 = np.asarray(rho, np.float64)
    p_net = 0.5 * (1.0 - rho64)
    q = np.clip(rho64 / (1.0 - p_net), 0.0, 1.0 - 1e-9)
    base = deadline / (np.asarray(epochs, np.float64) * (1.0 - jitter * np.log1p(-q)))
    return base, p_net


def make_volatility(
    name: str,
    rho,
    *,
    stickiness: float = 0.8,
    seed: int = 0,
    epochs_choices: Tuple[int, ...] = (1, 2, 3, 4),
    deadline_slack: float = 1.5,
    jitter: float = 0.25,
    device=None,
):
    """Construct a named volatility model over success rates ``rho`` (K,)
    on ``device``: ``bernoulli | markov | deadline``; anything else raises.
    The deadline model draws each client's local epochs with
    ``np.random.default_rng(seed)``, as the JAX package does, and calibrates
    ``base_time`` so the joint marginal matches ``rho``.  ``device=None``
    means CUDA and raises without it."""
    device = resolve_device(device)
    rho_np = np.asarray(rho.detach().cpu() if torch.is_tensor(rho) else rho, np.float32)
    rho_t = torch.as_tensor(rho_np, dtype=_f32, device=device)
    if name == "bernoulli":
        return BernoulliVolatility(rho_t)
    if name == "markov":
        return MarkovVolatility(rho_t, stickiness)
    if name == "deadline":
        rng = np.random.default_rng(seed)
        epochs = np.asarray(rng.choice(epochs_choices, rho_np.shape[0]), np.float32)
        deadline = float(np.median(epochs) * deadline_slack)
        base, p_net = calibrate_deadline(rho_np.astype(np.float64), epochs, deadline, jitter)
        return DeadlineVolatility(
            epochs=torch.as_tensor(epochs, device=device),
            base_time=torch.as_tensor(base.astype(np.float32), device=device),
            deadline=deadline,
            p_net_fail=torch.as_tensor(p_net.astype(np.float32), device=device),
            jitter=jitter,
        )
    raise ValueError(f"unknown volatility model {name!r} (want bernoulli | markov | deadline)")


def model_to(model, device):
    """``model`` with every tensor field, and every nested model's, on
    ``device``."""
    kw = {}
    for f in dataclasses.fields(model):
        v = getattr(model, f.name)
        if torch.is_tensor(v):
            kw[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            kw[f.name] = v.to(device)
    return dataclasses.replace(model, **kw)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 0-d tensor beside ``like`` (a kernel multiplies by
    it as JAX multiplies by a weakly typed Python float)."""
    return torch.full((), v, dtype=_f32, device=like.device)


def _scale_row(u: torch.Tensor, lo: float) -> torch.Tensor:
    """A ``[0, 1)`` row moved to ``[lo, 1)``, as ``jax.random.uniform(
    minval=lo, maxval=1)`` scales its ``[0, 1)`` draw."""
    if lo:
        lo_t = _scalar(lo, u)
        u = torch.maximum(u * (1.0 - lo_t) + lo_t, lo_t)
    return u


def row_shape(n) -> tuple:
    """A ``draw_rows()`` entry's length as a shape: ``(n,)`` for a length,
    the shape itself for a model over a population with leading axes."""
    return (n,) if isinstance(n, int) else tuple(n)


def _per_client(rho: torch.Tensor):
    """The ``draw_rows()`` entry of a row over ``rho``'s clients: its length,
    or its shape when ``rho`` has leading axes (a ``(J, K_max)`` fleet)."""
    return rho.shape[0] if rho.dim() == 1 else tuple(rho.shape)


def uniform_rows(raw, rows) -> Tuple[torch.Tensor, ...]:
    """A model's rows from raw ``[0, 1)`` rows and its ``draw_rows()``."""
    return tuple(_scale_row(u, lo) for u, (_, lo) in zip(raw, rows))


def _draw(model, rng) -> Tuple[torch.Tensor, ...]:
    from repro_torch.core import prng  # the key stream's kernels import this module

    rows = model.draw_rows()
    if isinstance(rng, prng.Key):  # the JAX model's rows, drawn final under its sample key
        return tuple(prng.uniform(prng.derive(rng, path), row_shape(n), minval=lo)
                     for path, (n, lo) in zip(model.key_paths(), rows))
    dev = rng.device
    raw = [torch.rand(n, generator=rng, device=dev, dtype=_f32) for n, _ in rows]
    return uniform_rows(raw, rows)


class _Model:
    """The shared half of the draw protocol."""

    def draw(self, rng) -> Tuple[torch.Tensor, ...]:
        """One round's rows: from a ``core.prng.Key``, the JAX model's
        ``sample(key, state)`` draws (``key_paths``); from a
        ``torch.Generator``, ``uniform_rows`` of one ``torch.rand`` row
        each."""
        return _draw(self, rng)

    def to(self, device):
        return model_to(self, device)


@dataclass(frozen=True)
class BernoulliVolatility(_Model):
    """iid per-round success bits, ``x_{i,t} ~ Bern(rho_i)``: one uniform
    row, ``x = u < rho`` (``jax.random.bernoulli``'s comparison)."""

    rho: torch.Tensor  # (K,) float32

    def init_state(self):
        return torch.zeros_like(self.rho)

    def draw_rows(self):
        return ((_per_client(self.rho), 0.0),)

    def key_paths(self):
        return ((),)

    def sample(self, us, state):
        return (us[0] < self.rho).to(_f32), state


@dataclass(frozen=True)
class MarkovVolatility(_Model):
    """Gilbert-Elliott: a 2-state chain per client with stationary P(up) =
    rho.  The state is the ``(K,)`` P(up) row; the chain stays put with
    probability ``stickiness`` and otherwise redraws from the stationary
    law.  One uniform row a round: JAX's ``r_up`` (its ``r_flip`` key is
    split off and never used, so no row stands for it)."""

    rho: torch.Tensor  # (K,)
    stickiness: float = 0.8

    def init_state(self):
        return self.rho.clone()  # P(up) at t=0 equals stationary

    def draw_rows(self):
        return ((_per_client(self.rho), 0.0),)

    def key_paths(self):
        return (((0, 2),),)  # r_up = split(key)[0]

    def sample(self, us, state):
        up = (us[0] < state).to(_f32)
        s = self.stickiness
        p_next = _scalar(s, up) * up + _scalar(1.0 - s, up) * self.rho
        return up, p_next


@dataclass(frozen=True)
class DeadlineVolatility(_Model):
    """Failure = local training time past the deadline, or a transmission
    fault: ``time_i = epochs_i * base_i * (1 + jitter * Exp(1))``, success
    iff ``time_i <= deadline`` and ``u > p_net_fail_i``.  Two uniform rows:
    ``r_t`` (the exponential ``-log1p(-u)``, ``jax.random.exponential``'s
    transform) and ``r_n``."""

    epochs: torch.Tensor  # (K,) designated local epochs
    base_time: torch.Tensor  # (K,) per-epoch compute time
    deadline: float
    p_net_fail: torch.Tensor  # (K,)
    jitter: float = 0.5

    def init_state(self):
        return torch.zeros_like(self.epochs)

    def draw_rows(self):
        K = self.epochs.shape[0]
        return ((K, 0.0), (K, 0.0))

    def key_paths(self):
        return (((0, 2),), ((1, 2),))  # r_t, r_n = split(key)

    def sample(self, us, state):
        u_t, u_n = us
        noise = -torch.log1p(-u_t) * _scalar(self.jitter, u_t)
        t_i = self.epochs * self.base_time * (1.0 + noise)
        ok_time = (t_i <= _scalar(self.deadline, t_i)).to(_f32)
        ok_net = (~(u_n < self.p_net_fail)).to(_f32)
        return ok_time * ok_net, state


@dataclass(frozen=True)
class BinaryLag(_Model):
    """Lag view of a success-bit model: on time iff ``x = 1``, dead
    otherwise.  Consumes exactly the base model's rows, so an async run over
    it equals the synchronous run over ``base``."""

    base: object

    @property
    def rho(self):
        return getattr(self.base, "rho", None)

    def init_state(self):
        return self.base.init_state()

    def draw_rows(self):
        return self.base.draw_rows()

    def key_paths(self):
        return self.base.key_paths()

    def sample(self, us, state):
        x, vs = self.base.sample(us, state)
        lag = torch.where(x > 0, torch.zeros_like(x, dtype=torch.int32), torch.full_like(x, DEAD_LAG, dtype=torch.int32))
        return lag, vs


@dataclass(frozen=True)
class CompletionLag(_Model):
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

    def on_time_model(self) -> "OnTimeBits":
        """The sync-drop view of this model (the S = 0 reference)."""
        return OnTimeBits(self)

    def init_state(self):
        return self.base.init_state()

    def draw_rows(self):
        rows = self.base.draw_rows()
        K = rows[-1][0] if rows else self.base.K  # a model's last row is per client; a replay has none
        return rows + ((K, 0.0), (K, 1e-7))

    def key_paths(self):
        # r_base, r_late, r_lag = split(key, 3); the base model's own splits below r_base
        return tuple(((0, 3),) + p for p in self.base.key_paths()) + (((1, 3),), ((2, 3),))

    def sample(self, us, state):
        *u_base, u_late, u_lag = us
        x, vs = self.base.sample(tuple(u_base), state)
        late = u_late < _scalar(self.p_late, u_late)
        denom = torch.log1p(_scalar(-min(self.lag_decay, 1.0 - 1e-7), u_lag))
        extra = torch.floor(torch.log(u_lag) / denom).to(torch.int32)
        lag_late = 1 + torch.clamp(extra, 0, self.max_lag - 1)
        dead = torch.full_like(lag_late, DEAD_LAG)
        lag = torch.where(x > 0, torch.zeros_like(lag_late), torch.where(late, lag_late, dead))
        return lag.to(torch.int32), vs


@dataclass(frozen=True)
class OnTimeBits(_Model):
    """Success-bit view of a lag model, ``x = 1{lag == 0}``, consuming the
    lag model's rows: the synchronous S = 0 reference of an async run."""

    lag_model: object

    @property
    def rho(self):
        return getattr(self.lag_model, "rho", None)

    def init_state(self):
        return self.lag_model.init_state()

    def draw_rows(self):
        return self.lag_model.draw_rows()

    def key_paths(self):
        return self.lag_model.key_paths()

    def sample(self, us, state):
        lag, vs = self.lag_model.sample(us, state)
        return (lag == 0).to(_f32), vs

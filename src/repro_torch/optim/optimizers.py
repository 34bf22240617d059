"""Optimizers from scratch: SGD (+momentum) and AdamW, the port of
``repro.optim.optimizers``.

Plain functions over dicts of tensors, with the JAX package's contract:

    opt = sgd(lr=1e-2, momentum=0.9)
    state = opt.init(params)
    params, state = opt.update(params, grads, state, step)

``lr`` may be a float or a schedule ``step -> float32 0-d tensor``.  State
lives in the parameters' dtype unless ``fp32_state=True`` (AdamW; the FL
paper's SGD runs fp32 anyway).  The operations, their order and their
dtypes are those of the JAX package, one elementwise op at a time, so a
stacked ``(k, ...)`` cohort of parameters updates as k separate calls would.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

__all__ = ["Optimizer", "sgd", "adamw"]

Schedule = Union[float, Callable]
_f32 = torch.float32


def _map(fn, *trees):
    return {name: fn(*(t[name] for t in trees)) for name in trees[0]}


def _lr_at(lr: Schedule, step):
    return lr(step) if callable(lr) else lr


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def sgd(lr: Schedule = 1e-2, momentum: float = 0.0, nesterov: bool = False, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return _map(torch.zeros_like, params)

    def update(params, grads, state, step=0):
        lr_t = _lr_at(lr, step)
        if weight_decay:
            grads = _map(lambda g, p: g + weight_decay * p.to(g.dtype), grads, params)
        if momentum == 0.0:
            return _map(lambda p, g: (p - lr_t * g.to(_f32)).to(p.dtype), params, grads), ()
        new_state = _map(lambda m, g: momentum * m + g.to(m.dtype), state, grads)
        eff = _map(lambda m, g: g.to(m.dtype) + momentum * m, new_state, grads) if nesterov else new_state
        new_params = _map(lambda p, m: (p - lr_t * m.to(_f32)).to(p.dtype), params, eff)
        return new_params, new_state

    return Optimizer(init, update)


class AdamWState(NamedTuple):
    mu: dict
    nu: dict


def adamw(
    lr: Schedule = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    fp32_state: bool = True,
) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=_f32 if fp32_state else p.dtype, device=p.device)
        return AdamWState(_map(z, params), _map(z, params))

    def update(params, grads, state, step=0):
        lr_t = _lr_at(lr, step)
        t = torch.tensor(float(step), dtype=_f32) + 1.0
        c1 = 1.0 - b1**t
        c2 = 1.0 - b2**t
        mu = _map(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype), state.mu, grads)
        nu = _map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(v.dtype)), state.nu, grads)

        def upd(p, m, v):
            mh = m / c1.to(m.device)
            vh = v / c2.to(v.device)
            step_ = lr_t * (mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(mh.dtype))
            return (p.to(_f32) - step_).to(p.dtype)

        return _map(upd, params, mu, nu), AdamWState(mu, nu)

    return Optimizer(init, update)

"""Learning-rate schedules (pure functions of the step index), the port of
``repro.optim.schedules``: each returns a float32 0-d CPU tensor, computed in
float32 in the JAX package's order (a Python step is divided in float64 and
rounded, an int32 tensor step in float32, as JAX divides each)."""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine_decay", "warmup_cosine"]

_f32 = torch.float32


def _f(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_f32)


def constant(lr: float):
    return lambda step: _f(lr)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        x = torch.clamp(_f(step / max(total_steps, 1)), 0.0, 1.0)
        return lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * x)))

    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    cd = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        w = torch.clamp(_f(step / max(warmup, 1)), max=1.0)
        # an int32 step, as JAX's jnp.maximum hands it on: cd divides in float32
        return w * cd(torch.clamp(torch.as_tensor(step - warmup, dtype=torch.int32), min=0))

    return f

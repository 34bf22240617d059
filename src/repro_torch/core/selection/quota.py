"""Fairness-quota schedules ``sigma_t`` (paper §VI-A2 and §VI-B).

Every schedule returns a float32 0-d tensor on the device of the round
counter ``t`` it is given, in ``[0, k/K]``.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.device import resolve_device

__all__ = ["make_quota_schedule"]


def make_quota_schedule(name: str, k: int, K: int, T: int, frac: float = 0.0, device=None) -> Callable:
    """Build ``sigma(t)`` for ``t`` an int32 0-d tensor.

    Names: ``const`` (``frac * k/K``), ``inc`` (0 for ``t < T//4``, then
    ``k/K``), ``linear`` (ramp 0 -> k/K over the horizon), ``cosine``
    (smooth ramp 0 -> k/K).  ``device`` holds the constant schedule's value
    (``None``: CUDA, which raises without it).
    """
    device = resolve_device(device)
    cap = k / K
    f32 = torch.float32

    if name == "const":
        v = torch.tensor(frac * cap, dtype=f32, device=device)
        return lambda t: v
    if name == "inc":
        thresh = T // 4
        return lambda t: torch.where(
            t >= thresh, torch.full((), cap, dtype=f32, device=t.device), torch.zeros((), dtype=f32, device=t.device)
        )
    span = max(T - 1, 1)
    if name == "linear":
        return lambda t: cap * torch.clamp(t / span, 0.0, 1.0).to(f32)
    if name == "cosine":
        return lambda t: (cap * 0.5 * (1.0 - torch.cos(math.pi * torch.clamp(t / span, 0.0, 1.0)))).to(f32)
    raise ValueError(f"unknown quota schedule {name!r}")

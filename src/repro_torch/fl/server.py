"""Volatility resolution for a run (the part of ``repro.fl.server`` that the
selection round needs; the training loop comes with the FL stack)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.volatility import make_volatility, paper_success_rates

__all__ = ["build_volatility"]


def build_volatility(fl_cfg: FLConfig, K: int, volatility=None, device=None):
    """Resolve the run's volatility spec to ``(vol, rho)`` on ``device``.

    ``volatility`` (or, when omitted, ``fl_cfg.volatility``) is a builtin
    name built over the paper's class rates, or a model object passed
    through (``rho`` from its ``rho`` if present, else the paper classes).
    Scenario names raise until the scenarios are ported.
    """
    spec = fl_cfg.volatility if volatility is None else volatility
    if not isinstance(spec, str):
        vol = spec.to(device) if hasattr(spec, "to") else spec
        rho = getattr(vol, "rho", None)
        if rho is None:
            rho = paper_success_rates(K, fl_cfg.success_rates)
        return vol, torch.as_tensor(rho, dtype=torch.float32, device=device)
    if spec in ("bernoulli", "markov", "deadline"):
        vol = make_volatility(spec, paper_success_rates(K, fl_cfg.success_rates), device=device)
        return vol, vol.rho
    raise NotImplementedError(
        f"volatility {spec!r} is not a builtin model; the scenarios are not ported yet (ROADMAP.md A6)"
    )

"""Volatility resolution for a run (the part of ``repro.fl.server`` that the
selection round needs; the training loop comes with the FL stack)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.volatility import make_volatility, paper_success_rates
from repro_torch.device import resolve_device

__all__ = ["build_volatility"]


def build_volatility(fl_cfg: FLConfig, K: int, volatility=None, device=None):
    """Resolve the run's volatility spec to ``(vol, rho)`` on ``device``.

    ``volatility`` (or, when omitted, ``fl_cfg.volatility``) is a builtin
    name (``bernoulli | markov | deadline``) built over the paper's class
    rates with the config's stickiness, seed and local epochs; a
    ``repro_torch.scenarios`` name, made at ``(K, fl_cfg.rounds,
    fl_cfg.seed)`` with its own rate hint; or a model object passed through
    (``rho`` from its ``rho``, else its ``marginal_rate()``, else the paper
    classes).  ``device=None`` means CUDA, and raises without it.
    """
    device = resolve_device(device)
    spec = fl_cfg.volatility if volatility is None else volatility
    if not isinstance(spec, str):
        vol = spec.to(device) if hasattr(spec, "to") else spec
        rho = getattr(vol, "rho", None)
        if rho is None and hasattr(vol, "marginal_rate"):
            rho = vol.marginal_rate()
        if rho is None:
            rho = paper_success_rates(K, fl_cfg.success_rates)
        return vol, torch.as_tensor(rho, dtype=torch.float32, device=device)
    if spec in ("bernoulli", "markov", "deadline"):
        vol = make_volatility(
            spec, paper_success_rates(K, fl_cfg.success_rates), stickiness=fl_cfg.markov_stickiness,
            seed=fl_cfg.seed, epochs_choices=fl_cfg.local_epochs, device=device,
        )
        return vol, torch.as_tensor(paper_success_rates(K, fl_cfg.success_rates), device=device)
    from repro_torch.scenarios.registry import make_scenario  # the scenarios import the engine

    try:
        vol, rho = make_scenario(spec, K, fl_cfg.rounds, seed=fl_cfg.seed, device=device)
    except KeyError as e:
        raise ValueError(
            f"unknown volatility {spec!r}: not a builtin (bernoulli | markov | deadline) "
            f"and not a repro_torch.scenarios name ({e})"
        ) from None
    return vol, torch.as_tensor(rho, dtype=torch.float32, device=device)

"""Named scenario configurations, one id per volatility regime (the port of
``repro.scenarios.registry``).

A scenario is a recipe ``make(K, T, seed, device) -> (vol, rho_hint)``: a
volatility model sized to the population and horizon, and the marginal-rate
hint handed to rate-omniscient baselines (fedcs).  The numpy draws that
shape a scenario (timezone phases, crowd membership, deadline epochs) are
the JAX package's for the same seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.volatility import MarkovVolatility, make_volatility, paper_success_rates
from repro_torch.device import resolve_device

from .traces import DiurnalVolatility, FlashCrowdVolatility, RegionalOutageVolatility

__all__ = ["Scenario", "SCENARIOS", "get_scenario", "list_scenarios", "make_scenario"]


@dataclass(frozen=True)
class Scenario:
    name: str
    make: Callable  # (K: int, T: int, seed: int, device) -> (vol, rho_hint)
    description: str


def _paper_rho(K: int, device) -> torch.Tensor:
    return torch.as_tensor(paper_success_rates(K), device=device)


def _paper_iid(K, T, seed, device):
    vol = make_volatility("bernoulli", paper_success_rates(K), device=device)
    return vol, vol.rho


def _markov(K, T, seed, device, stickiness=0.8):
    rho = _paper_rho(K, device)
    return MarkovVolatility(rho, stickiness), rho


def _deadline(K, T, seed, device):
    return make_volatility("deadline", paper_success_rates(K), seed=seed, device=device), _paper_rho(K, device)


def _diurnal(K, T, seed, device):
    # timezones: K clients spread uniformly around the day, shuffled so a
    # volatility class is not confounded with a longitude band
    phase = np.random.default_rng(seed).permutation(K).astype(np.float32) / K
    vol = DiurnalVolatility(rho=_paper_rho(K, device), phase=torch.as_tensor(phase, device=device), amplitude=0.35,
                            period=max(8, min(48, T // 4)))
    return vol, vol.marginal_rate()


def _regional(K, T, seed, device, n_regions=8):
    # contiguous client blocks per region (classes repeat across regions)
    region = torch.as_tensor((np.arange(K) * n_regions // K).astype(np.int32), device=device)
    vol = RegionalOutageVolatility(rho=_paper_rho(K, device), region=region, n_regions=n_regions)
    return vol, vol.marginal_rate()


def _flash_crowd(K, T, seed, device):
    crowd = (np.random.default_rng(seed).random(K) < 0.3).astype(np.float32)
    t_start, t_end = T // 4, T // 4 + max(2, T // 4)
    vol = FlashCrowdVolatility(rho=_paper_rho(K, device), crowd=torch.as_tensor(crowd, device=device),
                               t_start=t_start, t_end=t_end)
    return vol, vol.marginal_rate()


SCENARIOS: Dict[str, Scenario] = {
    s.name: s
    for s in [
        Scenario("paper_iid", _paper_iid, "paper §VI-A: iid Bernoulli, 4 rate classes"),
        Scenario("markov", _markov, "Gilbert-Elliott per client, stickiness 0.8"),
        Scenario(
            "markov_sticky",
            lambda K, T, seed, device: _markov(K, T, seed, device, stickiness=0.95),
            "Gilbert-Elliott per client, stickiness 0.95 (long outages)",
        ),
        Scenario("deadline", _deadline, "mechanistic deadline misses + network faults, calibrated to rho"),
        Scenario("diurnal", _diurnal, "timezone-phased sinusoidal availability"),
        Scenario("regional_outage", _regional, "8-region correlated Gilbert-Elliott outages"),
        Scenario("flash_crowd", _flash_crowd, "30% crowd surges in for a window, churns out"),
    ]
}


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}")
    return SCENARIOS[name]


def make_scenario(name: str, K: int, T: int, seed: int = 0, device=None) -> Tuple[object, torch.Tensor]:
    """Instantiate scenario ``name`` on ``device`` (``None``: CUDA) ->
    ``(vol, rho_hint)``."""
    return get_scenario(name).make(K, T, seed, resolve_device(device))


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)

"""Selection-only simulator (no model training), the port of
``repro.core.sim``: any scheme for T rounds against a volatility model, with
the full (T, K) selection masks, success bits and allocations.

``selection_sim`` runs the whole-horizon runner (``engine.scan_sim``);
``selection_sim_loop`` steps the same round step (``RoundProgram.
build_step``) one call a round from the host, drawing each round's noise
with ``draw_noise`` from the same key stream (``PRNGKey(seed)``, the JAX
package's), so the two give identical trajectories, and JAX's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.prng import PRNGKey
from repro_torch.core.volatility import make_volatility, paper_success_rates
from repro_torch.device import resolve_device

__all__ = ["selection_sim", "selection_sim_loop"]


def selection_sim(
    scheme: str,
    K: int = 100,
    k: int = 20,
    T: int = 2500,
    quota: str = "const",
    frac: float = 0.0,
    eta: float = 0.5,
    sampler: str = "plackett_luce",
    volatility: str = "bernoulli",
    stickiness: float = 0.8,
    seed: int = 0,
    xs_override: Optional[np.ndarray] = None,
    backend: str = "scan",
    vol=None,
    rho=None,
    device=None,
) -> Dict[str, np.ndarray]:
    """The numerical experiment; ``backend`` is ``"scan"`` (the
    whole-horizon runner) or ``"loop"`` (one host call a round).
    ``volatility`` names a builtin model; ``vol`` passes any model object
    and ``rho`` the fedcs hint (default ``vol.rho`` or the paper classes)."""
    kw = dict(
        scheme=scheme, K=K, k=k, T=T, quota=quota, frac=frac, eta=eta, sampler=sampler,
        volatility=volatility, stickiness=stickiness, seed=seed, xs_override=xs_override,
        vol=vol, rho=rho, device=device,
    )
    if backend == "scan":
        from repro_torch.engine.scan_sim import scan_selection_sim

        return scan_selection_sim(**kw)
    if backend == "loop":
        return selection_sim_loop(**kw)
    raise ValueError(f"unknown sim backend {backend!r}")


def selection_sim_loop(
    scheme: str,
    K: int = 100,
    k: int = 20,
    T: int = 2500,
    quota: str = "const",
    frac: float = 0.0,
    eta: float = 0.5,
    sampler: str = "plackett_luce",
    volatility: str = "bernoulli",
    stickiness: float = 0.8,
    seed: int = 0,
    xs_override: Optional[np.ndarray] = None,
    vol=None,
    rho=None,
    device=None,
) -> Dict[str, np.ndarray]:
    from repro_torch.engine.round_program import RoundProgram  # the engine imports this package

    dev = resolve_device(device)
    fl = FLConfig(K=K, k=k, rounds=T, scheme=scheme, quota=quota, quota_frac=frac, eta=eta, sampler=sampler)
    if rho is None:
        rho = getattr(vol, "rho", None) if vol is not None else None
    if rho is None:
        rho = paper_success_rates(K)
    if vol is None:
        vol = make_volatility(volatility, rho, stickiness=stickiness, seed=seed, device=dev)
    program = RoundProgram(fl=fl, vol=vol, rho=rho, override="dense" if xs_override is not None else "none",
                           device=dev)
    step, state = program.build_step()
    gen = program.generator(PRNGKey(seed, dev))
    carry = (state,)
    masks, xs, ps, sigmas = [], [], [], []
    for t in range(T):
        x_over = None if xs_override is None else torch.as_tensor(np.asarray(xs_override[t], np.float32), device=dev)
        carry, (mask, x, p, sigma) = step(carry, x_over, program.draw_noise(gen))
        masks.append(mask)
        xs.append(x)
        ps.append(p)
        sigmas.append(sigma)
    masks = torch.stack(masks).cpu().numpy()
    return {
        "masks": masks,
        "xs": torch.stack(xs).cpu().numpy(),
        "ps": torch.stack(ps).cpu().numpy(),
        "sigmas": torch.stack(sigmas).cpu().numpy(),
        "counts": masks.sum(0),
    }

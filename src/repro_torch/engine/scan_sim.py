"""Whole-horizon selection simulator (the port of ``repro.engine.scan_sim``).

Thin wrappers over ``RoundProgram.build_runner``, whose runner replays one
CUDA graph of the round step a round on the card (the counterpart of JAX's
``jit`` over ``lax.scan``):

* ``build_scan_runner(fl, vol, rho, ...)``: a whole-horizon runner, sync or
  async, generated or replayed outcomes, with ``build_runner``'s contracts;
* ``scan_selection_sim`` / ``async_selection_sim``: the numerical
  experiments, returning numpy dicts as the JAX package does;
* ``make_sim_step``: the bare round step.

As JAX caches its compiled runner per static configuration
(``lru_cache``), ``scan_selection_sim`` caches its built runners (static
buffers and, on the card, the captured graph) per configuration, device and
threefry mode (a runner keeps the mode of its first key), so a repeated call
replays without capturing again.  Runs given a model
object (``vol`` or ``rho``) build a runner of their own each call, as in
JAX.

Noise is the JAX package's key stream from ``PRNGKey(seed)`` (``core.prng``,
see ``round_program``), in the mode ``core.prng.threefry_partitionable``
sets: ``seed`` gives the JAX package's selections under the same mode.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.prng import PRNGKey, default_partitionable
from repro_torch.core.volatility import CompletionLag, make_volatility, paper_success_rates
from repro_torch.device import resolve_device
from repro_torch.engine.round_program import RoundProgram, staleness_ring_step

__all__ = [
    "make_sim_step",
    "build_scan_runner",
    "scan_selection_sim",
    "async_selection_sim",
    "staleness_ring_step",
]


def make_sim_step(fl: FLConfig, quota_fn, vol, rho, use_override=False, override: Optional[str] = None,
                  lean: bool = False, staleness: Optional[int] = None, alpha: float = 0.5,
                  feedback: str = "deadline", device=None):
    """The round step ``step(carry, x_over, noise)`` of the dense
    ``RoundProgram`` (see that module for the carry and outputs);
    ``use_override`` is the bool spelling of ``override="dense"``,
    ``quota_fn`` overrides the schedule the program derives from ``fl``."""
    mode = override if override is not None else ("dense" if use_override else "none")
    program = RoundProgram(fl=fl, vol=vol, rho=rho, override=mode, staleness=staleness, alpha=alpha,
                           feedback=feedback, quota_fn=quota_fn, device=device)
    step, _ = program.build_step(lean=lean)
    return step


def build_scan_runner(fl: FLConfig, vol, rho, override: str = "none", outputs: str = "full",
                      staleness: Optional[int] = None, alpha: float = 0.5, mesh=None, carry_key: bool = False,
                      scan_length: Optional[int] = None, feedback: str = "deadline", block: int = 1,
                      taps: bool = False, sketch=None, fused: bool = False, device=None):
    """A whole-horizon runner for any volatility model: ``(run, state0)``
    with the ``RoundProgram.build_runner`` signatures (``run(state, key,
    xs_in)``, ``key`` a ``core.prng.Key``, or an int seed or a generator
    state for the port's Philox stream).  Hold on to ``run``
    to replay its captured step across calls."""
    program = RoundProgram(fl=fl, vol=vol, rho=rho, override=override, staleness=staleness, alpha=alpha,
                           feedback=feedback, mesh=mesh, block=block, fused=fused, device=device)
    return program.build_runner(outputs=outputs, carry_key=carry_key, scan_length=scan_length, taps=taps,
                                sketch=sketch)


@functools.lru_cache(maxsize=64)
def _cached_runner(fl: FLConfig, volatility: str, stickiness: float, seed: int, override: str, taps: bool,
                   fused: bool, device: torch.device, partitionable: bool):
    """The runner of one static configuration, built once a process for
    each threefry mode of its keys."""
    rho = paper_success_rates(fl.K)
    vol = make_volatility(volatility, rho, stickiness=stickiness, seed=seed, device=device)
    return build_scan_runner(fl, vol, rho, override=override, taps=taps, fused=fused, device=device)


def _numpy(t):
    return t.detach().cpu().numpy()


def _taps_to_numpy(payload) -> dict:
    """Host-side view of a runner's trailing taps payload."""
    out = {
        "series": {n: _numpy(v) for n, v in payload["series"].items()},
        "counters": {n: float(v) for n, v in payload["counters"].items()},
    }
    if "sketches" in payload:
        out["sketches"] = {n: _numpy(v) for n, v in payload["sketches"].items()}
    return out


def scan_selection_sim(
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
    packed_override: Optional[np.ndarray] = None,
    vol=None,
    rho=None,
    allocator: str = "sort",
    taps: bool = False,
    fused: bool = False,
    pow_d: int = 40,
    device=None,
) -> Dict[str, np.ndarray]:
    """The numerical experiment over a whole horizon: ``masks``, ``xs``,
    ``ps`` (T, K), ``sigmas`` (T,), ``counts`` (K,), as numpy.

    ``vol`` (a model object) takes precedence over the ``volatility`` name;
    ``xs_override`` replays a dense ``(T, K)`` trace, ``packed_override`` a
    ``(T, ceil(K/8))`` 1-bit trace decoded each round.  ``pow_d`` is the
    power-of-choice candidate-set size (``FLConfig``'s default, 40, holds
    only for ``k <= 40``).  ``taps=True`` adds ``"taps"``.
    """
    if xs_override is not None and packed_override is not None:
        raise ValueError("pass at most one of xs_override / packed_override")
    dev = resolve_device(device)
    override = "dense" if xs_override is not None else ("packed" if packed_override is not None else "none")
    fl = FLConfig(K=K, k=k, rounds=T, scheme=scheme, quota=quota, quota_frac=frac, eta=eta, sampler=sampler,
                  allocator=allocator, pow_d=pow_d)
    if vol is not None or rho is not None:
        if rho is None:
            rho = getattr(vol, "rho", None)
        if rho is None:
            rho = paper_success_rates(K)
        if vol is None:
            vol = make_volatility(volatility, rho, stickiness=stickiness, seed=seed, device=dev)
        run, state = build_scan_runner(fl, vol, rho, override=override, taps=taps, fused=fused, device=dev)
    else:
        run, state = _cached_runner(fl, volatility, stickiness, seed, override, taps, fused, dev,
                                    default_partitionable())
    if override == "dense":
        xs_in = torch.as_tensor(np.asarray(xs_override, np.float32), device=dev)
    elif override == "packed":
        xs_in = torch.as_tensor(np.asarray(packed_override, np.uint8), device=dev)
    else:
        xs_in = None
    _, masks, xs, ps, sigmas, *rest = run(state, PRNGKey(seed, dev), xs_in)
    masks = _numpy(masks)
    out = {"masks": masks, "xs": _numpy(xs), "ps": _numpy(ps), "sigmas": _numpy(sigmas), "counts": masks.sum(0)}
    if taps:
        out["taps"] = _taps_to_numpy(rest[-1])
    return out


def async_selection_sim(
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
    staleness: int = 2,
    alpha: float = 0.5,
    p_late: float = 0.7,
    lag_decay: float = 0.5,
    lag_model=None,
    rho=None,
    outputs: str = "full",
    feedback: str = "deadline",
    packed_lag_override: Optional[np.ndarray] = None,
    taps: bool = False,
    fused: bool = False,
    device=None,
) -> Dict[str, np.ndarray]:
    """The async numerical experiment: completion-lag outcomes, a staleness
    ring of ``staleness`` rounds, late credit ``alpha**lag``.

    ``lag_model`` defaults to the named ``volatility`` model wrapped in
    ``CompletionLag(p_late, lag_decay, max_lag=max(staleness, 1))``;
    ``packed_lag_override`` replays a 2-bit lag trace instead.  Returns
    per-round ``on_time`` / ``stale``, ``cep``, ``on_time_total``,
    ``sel_counts``, ``final_logw`` and, with ``outputs="full"``, the (T, K)
    masks, lags, ps, arrived and counts, as numpy.
    """
    dev = resolve_device(device)
    fl = FLConfig(K=K, k=k, rounds=T, scheme=scheme, quota=quota, quota_frac=frac, eta=eta, sampler=sampler)
    override = "none" if packed_lag_override is None else "packed_lags"
    if lag_model is None:
        if rho is None:
            rho = paper_success_rates(K)
        base = make_volatility(volatility, rho, stickiness=stickiness, seed=seed, device=dev)
        lag_model = CompletionLag(base, p_late=p_late, lag_decay=lag_decay, max_lag=max(int(staleness), 1))
    if rho is None:
        rho = getattr(lag_model, "rho", None)
    if rho is None:
        rho = paper_success_rates(K)
    run, state = build_scan_runner(fl, lag_model, rho, override=override, outputs=outputs, staleness=int(staleness),
                                   alpha=alpha, feedback=feedback, taps=taps, fused=fused, device=dev)
    xs_in = None if override == "none" else torch.as_tensor(np.asarray(packed_lag_override, np.uint8), device=dev)
    if outputs == "lean":
        state, on_time, stale, sigmas, *rest = run(state, PRNGKey(seed, dev), xs_in)
        out = {}
    else:
        state, masks, lags, ps, sigmas, arrived, *rest = run(state, PRNGKey(seed, dev), xs_in)
        on_time = (masks * (lags == 0)).sum(1)
        stale = arrived.sum(1)
        masks = _numpy(masks)
        out = {"masks": masks, "lags": _numpy(lags), "ps": _numpy(ps), "arrived": _numpy(arrived),
               "counts": masks.sum(0)}
    out.update({
        "on_time": _numpy(on_time),
        "stale": _numpy(stale),
        "sigmas": _numpy(sigmas),
        "cep": float(state.cep),
        "on_time_total": float(state.succ_hist),
        "sel_counts": _numpy(state.sel_counts),
        "final_logw": _numpy(state.e3cs.logw),
    })
    if taps:
        out["taps"] = _taps_to_numpy(rest[-1])
    return out

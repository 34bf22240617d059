"""Server state and the staged allocate + select stage (the part of
``repro.fl.round`` that the selection round needs).

Noise.  Where the JAX package hands ``select`` a key, the port hands it the
round's noise as tensors (``RoundNoise``), drawn by the caller in the order
``select_draws`` names: E3CS with the Plackett-Luce sampler takes a Gumbel
row, the systematic sampler a permutation and a 0-d uniform, ``random``
and ``pow_d`` a permutation, ``fedcs`` a uniform row, and ``ucb`` nothing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.selection import (
    E3CSState,
    e3cs_init,
    e3cs_probs,
    fedcs_select,
    gumbel_from_uniform,
    pow_d_select,
    random_select,
    sample_selection,
    selection_mask,
    ucb_init,
    ucb_select,
)
from repro_torch.device import resolve_device
from repro_torch.obs.trace import stage

__all__ = [
    "ServerState",
    "RoundNoise",
    "SCHEMES",
    "SAMPLERS",
    "init_server_state",
    "make_select_fn",
    "select_draws",
    "select_noise",
]

SCHEMES = ("e3cs", "random", "fedcs", "pow_d", "ucb")
SAMPLERS = ("plackett_luce", "systematic")


class ServerState(NamedTuple):
    params: object
    e3cs: E3CSState
    ucb: object  # UCBState
    loss_cache: torch.Tensor  # (K,) pow-d loss estimates
    vol_state: object  # the volatility model's state: a tensor or a tuple of tensors
    t: torch.Tensor  # int32 0-d
    sel_counts: torch.Tensor  # (K,)
    cep: torch.Tensor  # float32 0-d
    succ_hist: torch.Tensor  # float32 0-d successes observed


class RoundNoise(NamedTuple):
    """One round's noise: the selection's (``g`` a Gumbel row, ``perm`` a
    permutation row, ``v`` a uniform row or 0-d uniform; each None where the
    scheme takes none) and the volatility model's uniform rows ``u`` (empty
    when outcomes come from a trace)."""

    g: Optional[torch.Tensor] = None
    u: Tuple[torch.Tensor, ...] = ()
    perm: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None


def init_server_state(params, K: int, vol_state, device=None) -> ServerState:
    """A fresh server state for ``K`` clients on ``device`` (``None``:
    CUDA, which raises without it)."""
    device = resolve_device(device)
    f32 = torch.float32
    return ServerState(
        params=params,
        e3cs=e3cs_init(K, device),
        ucb=ucb_init(K, device),
        loss_cache=torch.full((K,), 1e9, dtype=f32, device=device),  # unexplored => very lossy
        vol_state=vol_state,
        t=torch.zeros((), dtype=torch.int32, device=device),
        sel_counts=torch.zeros(K, dtype=f32, device=device),
        cep=torch.zeros((), dtype=f32, device=device),
        succ_hist=torch.zeros((), dtype=f32, device=device),
    )


def _check(fl_cfg) -> None:
    if fl_cfg.allocator not in ("sort", "bisect"):
        raise ValueError(f"unknown allocator {fl_cfg.allocator!r} (want 'sort' or 'bisect')")
    if fl_cfg.scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {fl_cfg.scheme!r} (want one of {SCHEMES})")
    if fl_cfg.scheme == "e3cs" and fl_cfg.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampling method: {fl_cfg.sampler!r}")
    if fl_cfg.scheme == "pow_d" and fl_cfg.k > fl_cfg.pow_d:
        raise ValueError(f"pow_d selects k={fl_cfg.k} of d={fl_cfg.pow_d} candidates; need k <= d")


def select_draws(fl_cfg, K: int) -> tuple:
    """The raw draws one round's selection takes, in order: ``("rand",
    shape)`` (a ``[0, 1)`` float32 draw) or ``("perm", (n,))`` (a
    permutation of ``n``)."""
    _check(fl_cfg)
    scheme = fl_cfg.scheme
    if scheme == "e3cs":
        return (("rand", (K,)),) if fl_cfg.sampler == "plackett_luce" else (("perm", (K,)), ("rand", ()))
    return {"random": (("perm", (K,)),), "fedcs": (("rand", (K,)),), "pow_d": (("perm", (K,)),), "ucb": ()}[scheme]


def select_noise(fl_cfg, raw) -> dict:
    """The selection's ``RoundNoise`` fields from its raw draws
    (``select_draws``): the Gumbel transform of E3CS's row, the rest as
    drawn."""
    scheme = fl_cfg.scheme
    if scheme == "e3cs":
        if fl_cfg.sampler == "plackett_luce":
            return {"g": gumbel_from_uniform(raw[0])}
        return {"perm": raw[0], "v": raw[1]}
    if scheme in ("random", "pow_d"):
        return {"perm": raw[0]}
    if scheme == "fedcs":
        return {"v": raw[0]}
    return {}


def make_select_fn(fl_cfg, quota_fn, rho=None):
    """``select(state, noise) -> (idx, p, capped, sigma)``: the scheme's
    allocation and cohort from the round's ``RoundNoise``.  E3CS allocates
    by ``fl_cfg.allocator`` (sorted or bisection) and samples by
    ``fl_cfg.sampler``; the baselines report ``p = k/K`` (random) or their
    cohort mask as ``p``.  ``rho`` is FedCS's success-rate hint."""
    _check(fl_cfg)
    K, k, scheme = fl_cfg.K, fl_cfg.k, fl_cfg.scheme
    allocator = fl_cfg.allocator

    def select(state: ServerState, noise: RoundNoise):
        sigma = quota_fn(state.t)
        dev = state.sel_counts.device
        capped = torch.zeros(K, dtype=torch.bool, device=dev)
        if scheme == "e3cs":
            with stage("round.allocate"):
                if allocator == "bisect":
                    from repro_torch.engine.sharded import masked_prob_alloc  # the engine imports this module

                    w = torch.exp(state.e3cs.logw - torch.max(state.e3cs.logw))
                    p, capped = masked_prob_alloc(w, k, sigma)
                else:
                    p, capped = e3cs_probs(state.e3cs, k, sigma)
            with stage("round.sample"):
                idx = sample_selection(noise, p, k, fl_cfg.sampler)
            return idx, p, capped, sigma
        if scheme == "random":
            idx = random_select(noise.perm, K, k)
            return idx, torch.full((K,), k / K, dtype=torch.float32, device=dev), capped, sigma
        if scheme == "fedcs":
            idx = fedcs_select(rho, k, noise.v)
        elif scheme == "ucb":
            idx = ucb_select(state.ucb, k)
        else:
            idx = pow_d_select(noise.perm, state.loss_cache, k, fl_cfg.pow_d)
        return idx, selection_mask(idx, K), capped, sigma

    return select

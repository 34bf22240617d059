"""Server state and the staged allocate + select stage (the part of
``repro.fl.round`` that the selection round needs)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.selection import E3CSState, e3cs_init, e3cs_probs, plackett_luce_sample
from repro_torch.obs.trace import stage

__all__ = ["ServerState", "init_server_state", "make_select_fn"]


class ServerState(NamedTuple):
    params: object
    e3cs: E3CSState
    ucb: object  # UCB selector state: None until the baselines are ported
    loss_cache: torch.Tensor  # (K,) pow-d loss estimates
    vol_state: torch.Tensor
    t: torch.Tensor  # int32 0-d
    sel_counts: torch.Tensor  # (K,)
    cep: torch.Tensor  # float32 0-d
    succ_hist: torch.Tensor  # float32 0-d successes observed


def init_server_state(params, K: int, vol_state, device=None) -> ServerState:
    f32 = torch.float32
    return ServerState(
        params=params,
        e3cs=e3cs_init(K, device),
        ucb=None,
        loss_cache=torch.full((K,), 1e9, dtype=f32, device=device),  # unexplored => very lossy
        vol_state=vol_state,
        t=torch.zeros((), dtype=torch.int32, device=device),
        sel_counts=torch.zeros(K, dtype=f32, device=device),
        cep=torch.zeros((), dtype=f32, device=device),
        succ_hist=torch.zeros((), dtype=f32, device=device),
    )


def make_select_fn(fl_cfg, quota_fn):
    """``select(state, g) -> (idx, p, capped, sigma)``: E3CS allocation
    (sorted or bisection) and the Plackett-Luce draw from the Gumbel row
    ``g``.  The other schemes and the systematic sampler raise."""
    k = fl_cfg.k
    allocator = fl_cfg.allocator
    if allocator not in ("sort", "bisect"):
        raise ValueError(f"unknown allocator {allocator!r} (want 'sort' or 'bisect')")
    if fl_cfg.scheme != "e3cs":
        raise NotImplementedError(
            f"scheme {fl_cfg.scheme!r} is not ported yet (ROADMAP.md A3: the other schemes)"
        )
    if fl_cfg.sampler != "plackett_luce":
        raise NotImplementedError(
            f"sampler {fl_cfg.sampler!r} is not ported yet (ROADMAP.md A3: the systematic sampler)"
        )

    def select(state: ServerState, g: torch.Tensor):
        sigma = quota_fn(state.t)
        with stage("round.allocate"):
            if allocator == "bisect":
                from repro_torch.engine.sharded import masked_prob_alloc  # the engine imports this module

                w = torch.exp(state.e3cs.logw - torch.max(state.e3cs.logw))
                p, capped = masked_prob_alloc(w, k, sigma)
            else:
                p, capped = e3cs_probs(state.e3cs, k, sigma)
        with stage("round.sample"):
            idx = plackett_luce_sample(g, p, k)
        return idx, p, capped, sigma

    return select

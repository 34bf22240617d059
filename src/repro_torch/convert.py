"""Carry a round program's state across from the JAX package and back.

The selection engine holds no model weights: what a run carries is its
per-client state.  ``state_from_jax`` takes the JAX ``ServerState`` and
staleness rings as numpy arrays under these names and builds the port's
``ServerState`` and rings on a device; ``state_to_numpy`` is its inverse.

    logw        (K,)   float32  E3CS log-weights (ServerState.e3cs.logw)
    t           ()     int32    round counter (ServerState.t and e3cs.t)
    sel_counts  (K,)   float32
    loss_cache  (K,)   float32
    vol_state   (K,)   float32  the volatility model's carried state
    cep         ()     float32
    succ_hist   ()     float32
    credit      (S, K) float32  async only
    fb          (S, K) float32  async under late_credit feedback only
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.selection import E3CSState
from repro_torch.device import resolve_device
from repro_torch.fl.round import ServerState

__all__ = ["state_from_jax", "state_to_numpy", "STATE_FIELDS"]

STATE_FIELDS = ("logw", "t", "sel_counts", "loss_cache", "vol_state", "cep", "succ_hist")
_DTYPES = {"t": np.int32}


def state_from_jax(arrays: Dict[str, np.ndarray], device=None) -> Tuple[ServerState, tuple]:
    """``(state, rings)`` on ``device`` from the named numpy arrays; ``rings``
    is ``()`` (sync), ``(credit,)`` or ``(credit, fb)``."""
    device = resolve_device(device)
    missing = [f for f in STATE_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"state_from_jax: missing arrays {missing}")

    def tensor(name):
        a = np.array(arrays[name], dtype=_DTYPES.get(name, np.float32))  # a writable copy
        return torch.from_numpy(a).to(device)

    t = tensor("t")
    state = ServerState(
        params={},
        e3cs=E3CSState(logw=tensor("logw"), t=t.clone()),
        ucb=None,
        loss_cache=tensor("loss_cache"),
        vol_state=tensor("vol_state"),
        t=t,
        sel_counts=tensor("sel_counts"),
        cep=tensor("cep"),
        succ_hist=tensor("succ_hist"),
    )
    rings = tuple(tensor(name) for name in ("credit", "fb") if name in arrays)
    return state, rings


def state_to_numpy(state: ServerState, rings: tuple = ()) -> Dict[str, np.ndarray]:
    """The named numpy arrays of ``state`` and ``rings`` (the inverse of
    ``state_from_jax``)."""
    out = {
        "logw": state.e3cs.logw,
        "t": state.t,
        "sel_counts": state.sel_counts,
        "loss_cache": state.loss_cache,
        "vol_state": state.vol_state,
        "cep": state.cep,
        "succ_hist": state.succ_hist,
    }
    out.update(zip(("credit", "fb"), rings))
    return {name: v.detach().cpu().numpy() for name, v in out.items()}

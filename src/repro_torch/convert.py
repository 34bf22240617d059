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

Under a mesh the JAX state is ``K_pad`` wide and each rank of the port holds
its ``(Ks,)`` slab: ``shard_arrays`` cuts a rank's slab out of the named
arrays (then ``state_from_jax``), and ``gather_state`` all-gathers the
ranks' slabs back into ``K_pad``-wide arrays on every rank.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.selection import E3CSState
from repro_torch.device import resolve_device
from repro_torch.fl.round import ServerState

__all__ = ["state_from_jax", "state_to_numpy", "shard_arrays", "gather_state", "STATE_FIELDS"]

STATE_FIELDS = ("logw", "t", "sel_counts", "loss_cache", "vol_state", "cep", "succ_hist")
_DTYPES = {"t": np.int32}
_SCALARS = ("t", "cep", "succ_hist")  # replicated on every rank; the rest are per client (last axis)


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
    return {name: v.detach().cpu().numpy() for name, v in _named(state, rings).items()}


def _named(state: ServerState, rings: tuple) -> Dict[str, torch.Tensor]:
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
    return out


def shard_arrays(arrays: Dict[str, np.ndarray], rank: int, D: int) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s slab of the named arrays of a ``K_pad``-wide mesh
    state: the last axis of every per-client array cut into ``D`` equal
    slabs; the scalars as they are."""
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        if name in _SCALARS:
            out[name] = a
            continue
        if a.shape[-1] % D:
            raise ValueError(f"shard_arrays: {name} has {a.shape[-1]} columns, not a multiple of D={D}")
        Ks = a.shape[-1] // D
        out[name] = a[..., rank * Ks:(rank + 1) * Ks]
    return out


def gather_state(state: ServerState, rings: tuple, mesh) -> Dict[str, np.ndarray]:
    """The named ``K_pad``-wide numpy arrays of a mesh state, on every rank:
    ``state_to_numpy`` of the ranks' slabs gathered in rank order."""

    def gather(t):
        parts = mesh.all_gather(t).reshape(mesh.size, *t.shape)
        return torch.cat(list(parts), dim=-1)

    return {
        name: (t if name in _SCALARS else gather(t)).detach().cpu().numpy()
        for name, t in _named(state, rings).items()
    }

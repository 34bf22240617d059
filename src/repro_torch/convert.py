"""Carry a round program's state across from the JAX package and back.

The selection engine holds no model weights: what a run carries is its
per-client state.  ``state_from_jax`` takes the JAX ``ServerState`` and
staleness rings as numpy arrays under these names and builds the port's
``ServerState`` and rings on a device; ``state_to_numpy`` is its inverse.

    logw        (K,)   float32  E3CS log-weights (ServerState.e3cs.logw)
    t           ()     int32    round counter (ServerState.t and e3cs.t)
    sel_counts  (K,)   float32
    loss_cache  (K,)   float32
    vol_state   (K,)   float32  the volatility model's carried state: one
                                array, or a tuple of them for a model whose
                                state is a pytree (a round index, int32;
                                a region row; a flash crowd's (alive, t))
    cep         ()     float32
    succ_hist   ()     float32
    ucb_succ    (K,)   float32  the UCB selector's state (ServerState.ucb);
    ucb_pulls   (K,)   float32  optional in ``state_from_jax`` (zeros, the
    ucb_t       ()     int32    initial state, when absent)
    credit      (S, K) float32  async only
    fb          (S, K) float32  async under late_credit feedback only

The serving engines (``repro_torch.serve``) carry a JAX engine's state in
as well: ``slot_state_from_jax`` loads a JAX ``SlotEngine``'s mid-horizon
``(logw, t, pending, base_keys)`` into the port's engine built from the same
meta, and ``sharded_job_from_jax`` a JAX ``ShardedEngine`` job's
``ServerState``, rings and key (through ``state_from_jax``).  On an engine of
``stream="jax"`` (``core.prng``, the JAX key stream) the keys cross too and
the jobs continue with JAX's noise; on a Philox engine they are left behind
and a job continues with the port's noise from its seed.

The FL training server's state also holds the model's parameters:
``fl_state_from_jax`` is ``state_from_jax`` with ``arrays["params"]``, the
JAX package's CNN parameters, carried by ``cnn_params_from_jax``.  Its conv
kernels are HWIO and the port's OIHW (``models.cnn``), so those two are
permuted; the dense weights and biases cross as they are (``fc1``'s rows
keep the JAX package's flatten order).  ``cnn_params_to_numpy`` is the
inverse.

The model zoo's parameters cross as nested dicts with the reference's names
and layouts (``(d, H, hd)``, ``(E, d, 2, f)``, ...; no axis moves):
``lm_params_from_jax`` takes any family's tree of numpy arrays (JAX arrays
pass through ``np.asarray``), ``lm_params_to_numpy`` is its inverse, and
``caches_from_jax`` carries a prefilled cache tree (``KVCache``,
``MLACache``, ``SSMCache`` by their fields, the enc-dec ``cross`` pair) with
each stacked ``pos`` made one host ``int``.  A bf16 array leaves JAX as an
``ml_dtypes.bfloat16`` numpy array, which ``torch.from_numpy`` refuses: its
bits cross through a 16-bit integer view into ``torch.bfloat16``, exactly;
on the way back a bf16 tensor becomes float32 (exactly: numpy has no bf16).

Under a mesh the JAX state is ``K_pad`` wide and each rank of the port holds
its ``(Ks,)`` slab: ``shard_arrays`` cuts a rank's slab out of the named
arrays (then ``state_from_jax``), ``gather_state`` all-gathers the ranks'
slabs back into ``K_pad``-wide arrays on every rank, and ``join_slabs``
joins slabs a caller has gathered itself (the sharded serving engine's
checkpoint, on rank 0).  An array is per
client when its last axis is the population's (``sel_counts``'); the
scalars, UCB's ``(K,)`` state and a model's other state (a regional
outage's region row) are the same on every rank and pass as they are.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from torch.utils import _pytree as pytree

from repro_torch.core.selection import E3CSState, UCBState
from repro_torch.device import resolve_device
from repro_torch.fl.round import ServerState
from repro_torch.models.attention import KVCache
from repro_torch.models.mla import MLACache
from repro_torch.models.ssm import SSMCache

__all__ = ["state_from_jax", "state_to_numpy", "fl_state_from_jax", "cnn_params_from_jax", "cnn_params_to_numpy",
           "shard_arrays", "join_slabs", "gather_state", "slot_state_from_jax", "sharded_job_from_jax", "STATE_FIELDS",
           "lm_params_from_jax", "lm_params_to_numpy", "caches_from_jax"]

STATE_FIELDS = ("logw", "t", "sel_counts", "loss_cache", "vol_state", "cep", "succ_hist")
_DTYPES = {"t": np.int32, "ucb_t": np.int32}
_REPLICATED = ("t", "cep", "succ_hist", "ucb_succ", "ucb_pulls", "ucb_t")  # the same on every rank of a mesh
_UCB_FIELDS = ("ucb_succ", "ucb_pulls", "ucb_t")


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

    def vol_leaf(a):
        a = np.asarray(a)
        return torch.from_numpy(np.array(a, dtype=np.int32 if a.dtype.kind in "iu" else np.float32)).to(device)

    t = tensor("t")
    logw = tensor("logw")
    if all(name in arrays for name in _UCB_FIELDS):
        ucb = UCBState(*(tensor(name) for name in _UCB_FIELDS))
    else:
        ucb = UCBState(torch.zeros_like(logw), torch.zeros_like(logw), torch.zeros((), dtype=torch.int32, device=device))
    vs = arrays["vol_state"]
    state = ServerState(
        params={},
        e3cs=E3CSState(logw=logw, t=t.clone()),
        ucb=ucb,
        loss_cache=tensor("loss_cache"),
        vol_state=tuple(vol_leaf(a) for a in vs) if isinstance(vs, (tuple, list)) else vol_leaf(vs),
        t=t,
        sel_counts=tensor("sel_counts"),
        cep=tensor("cep"),
        succ_hist=tensor("succ_hist"),
    )
    rings = tuple(tensor(name) for name in ("credit", "fb") if name in arrays)
    return state, rings


_HWIO_TO_OIHW, _OIHW_TO_HWIO = (3, 2, 0, 1), (2, 3, 1, 0)


def _kernel_axes(a: np.ndarray, perm) -> np.ndarray:
    """``a`` with the last four axes of a conv kernel (ndim >= 4; leading
    axes, a cohort's, stay) permuted by ``perm``; any other leaf copied."""
    if a.ndim < 4:
        return np.array(a)
    lead = a.ndim - 4
    return np.ascontiguousarray(a.transpose(tuple(range(lead)) + tuple(lead + i for i in perm)))


def cnn_params_from_jax(arrays: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's CNN parameters (numpy, by name; a cohort's stacked
    ``(k, ...)`` leaves too) as the port's on ``device``: conv kernels HWIO
    -> OIHW, the rest as they are."""
    device = resolve_device(device)
    return {name: torch.from_numpy(_kernel_axes(np.asarray(a, dtype=np.float32), _HWIO_TO_OIHW)).to(device)
            for name, a in arrays.items()}


def cnn_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's CNN parameters in the JAX package's layout (numpy): the
    inverse of ``cnn_params_from_jax``."""
    return {name: _kernel_axes(t.detach().cpu().numpy(), _OIHW_TO_HWIO) for name, t in params.items()}


def fl_state_from_jax(arrays: Dict[str, np.ndarray], device=None) -> Tuple[ServerState, tuple]:
    """``state_from_jax`` of an FL training server's state: the named arrays
    plus ``params``, the JAX package's CNN parameters by name."""
    device = resolve_device(device)
    state, rings = state_from_jax(arrays, device)
    return state._replace(params=cnn_params_from_jax(arrays["params"], device)), rings


def state_to_numpy(state: ServerState, rings: tuple = ()) -> Dict[str, np.ndarray]:
    """The named numpy arrays of ``state`` and ``rings`` (the inverse of
    ``state_from_jax``)."""
    return {name: pytree.tree_map(lambda v: v.detach().cpu().numpy(), v) for name, v in _named(state, rings).items()}


def _named(state: ServerState, rings: tuple) -> Dict[str, torch.Tensor]:
    out = {
        "logw": state.e3cs.logw,
        "t": state.t,
        "sel_counts": state.sel_counts,
        "loss_cache": state.loss_cache,
        "vol_state": state.vol_state,
        "cep": state.cep,
        "succ_hist": state.succ_hist,
        **dict(zip(_UCB_FIELDS, state.ucb)),
    }
    out.update(zip(("credit", "fb"), rings))
    return out


def shard_arrays(arrays: Dict[str, np.ndarray], rank: int, D: int) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s slab of the named arrays of a ``K_pad``-wide mesh
    state: the last axis of every per-client array cut into ``D`` equal
    slabs; the replicated arrays as they are."""
    K_pad = np.shape(arrays["sel_counts"])[-1]
    if K_pad % D:
        raise ValueError(f"shard_arrays: the state has {K_pad} clients, not a multiple of D={D}")
    Ks = K_pad // D

    def cut(name, a):
        a = np.asarray(a)
        per_client = name not in _REPLICATED and a.ndim > 0 and a.shape[-1] == K_pad
        return a[..., rank * Ks:(rank + 1) * Ks] if per_client else a

    return {name: pytree.tree_map(lambda a: cut(name, a), v) for name, v in arrays.items()}


def join_slabs(parts) -> Dict[str, np.ndarray]:
    """The named ``K_pad``-wide arrays of a mesh state from its ranks' named
    slabs in rank order (the inverse of ``shard_arrays``): every per-client
    array joined along its last axis, the replicated ones taken from rank 0."""
    Ks = np.shape(parts[0]["sel_counts"])[-1]

    def join(name, *slabs):
        a = np.asarray(slabs[0])
        per_client = name not in _REPLICATED and a.ndim > 0 and a.shape[-1] == Ks
        return np.concatenate(slabs, axis=-1) if per_client else a

    return {name: pytree.tree_map(lambda *s: join(name, *s), *(p[name] for p in parts)) for name in parts[0]}


def gather_state(state: ServerState, rings: tuple, mesh) -> Dict[str, np.ndarray]:
    """The named ``K_pad``-wide numpy arrays of a mesh state, on every rank:
    ``state_to_numpy`` of the ranks' slabs gathered in rank order."""

    def gather(t):
        parts = mesh.all_gather(t).reshape(mesh.size, *t.shape)
        return torch.cat(list(parts), dim=-1)

    Ks = state.sel_counts.shape[-1]

    def host(name, t):
        per_client = name not in _REPLICATED and t.dim() > 0 and t.shape[-1] == Ks
        return (gather(t) if per_client else t).detach().cpu().numpy()

    return {name: pytree.tree_map(lambda t: host(name, t), v) for name, v in _named(state, rings).items()}


def _key_words(a) -> torch.Tensor:
    """JAX key words (uint32, numpy or JAX) as the port's int32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32).copy())


def slot_state_from_jax(engine, arrays) -> None:
    """Load a JAX ``SlotEngine``'s ``arrays()`` (as numpy: ``logw``, ``t``,
    ``pending``, ``base_keys``) into ``engine``, a port ``SlotEngine`` built
    from the JAX engine's ``meta()`` (``serve.engine_from_meta``), so the
    jobs continue mid-horizon; the base keys cross on an engine of
    ``stream="jax"`` and are left behind otherwise."""
    engine.load_arrays({
        "logw": torch.from_numpy(np.array(arrays["logw"], np.float32)),
        "t": torch.from_numpy(np.array(arrays["t"], np.int32)),
        "pending": torch.from_numpy(np.array(arrays["pending"], np.float32)),
        "seeds": engine.seeds,
        "base_keys": _key_words(arrays["base_keys"]) if engine.stream == "jax" else engine.base_keys,
    })


def sharded_job_from_jax(engine, uid: int, job) -> None:
    """Load one job of a JAX ``ShardedEngine`` (its ``arrays()[str(uid)]``:
    ``{"state": ServerState, "key", "rings"}``, the state a ``ServerState``
    or, read from a JAX checkpoint file, the list of its fields) into job
    ``uid`` of ``engine``, a port ``ShardedEngine`` built from the JAX
    engine's ``meta()`` at the same D: the state and rings through
    ``state_from_jax`` (the JAX state is ``K_pad`` wide; at D > 1 each rank
    of the port takes its slab, ``shard_arrays``), and on an engine of
    ``stream="jax"`` the key; the job's round follows the state's."""
    st = job["state"]
    if isinstance(st, list):  # ServerState's fields, packed in order
        st = ServerState(*st)
        st = st._replace(e3cs=E3CSState(*st.e3cs), ucb=UCBState(*st.ucb))
    named = {
        "logw": st.e3cs.logw, "t": st.t, "sel_counts": st.sel_counts, "loss_cache": st.loss_cache,
        "vol_state": st.vol_state, "cep": st.cep, "succ_hist": st.succ_hist,
        "ucb_succ": st.ucb.succ, "ucb_pulls": st.ucb.pulls, "ucb_t": st.ucb.t,
        **dict(zip(("credit", "fb"), job["rings"])),
    }
    key = _key_words(job["key"]) if engine.stream == "jax" else None
    engine.load_state(uid, pytree.tree_map(np.asarray, named), key=key)
    engine.jobs[uid]["t"] = int(np.asarray(st.t))


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: cross as its bits
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_jax(tree, device=None):
    """A model zoo parameter tree (nested dicts of numpy or JAX arrays) as
    the port's on ``device``, leaf for leaf: same names, shapes, dtypes and
    layouts."""
    device = resolve_device(device)

    def conv(t):
        return {k: conv(v) for k, v in t.items()} if isinstance(t, dict) else _tensor(t, device)

    return conv(tree)


def lm_params_to_numpy(params):
    """The inverse of ``lm_params_from_jax``: nested dicts of numpy arrays;
    a bf16 tensor comes back as float32 (each value exactly)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return conv(params)


_CACHES = {cls._fields: cls for cls in (KVCache, MLACache, SSMCache)}


def caches_from_jax(tree, device=None):
    """A model zoo cache tree of the JAX package (``prefill``'s or
    ``init_caches``'s: dicts of stacked ``KVCache`` / ``MLACache`` /
    ``SSMCache``, and the enc-dec ``cross`` pair) as the port's on
    ``device``.  A stacked cache's ``(L,)`` positions must be equal; they
    become the port's host ``int``."""
    device = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        fields = getattr(t, "_fields", None)
        if fields in _CACHES:
            pos = np.unique(np.asarray(t.pos))
            if pos.size != 1:
                raise ValueError(f"caches_from_jax: a stacked cache's layers hold different positions {pos}")
            return _CACHES[fields](*(_tensor(a, device) for a in t[:-1]), int(pos[0]))
        if isinstance(t, tuple):
            return tuple(conv(v) for v in t)
        return _tensor(t, device)

    return conv(tree)

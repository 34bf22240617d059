"""Bit-packed availability traces: record once, replay at fleet scale (the
port of ``repro.scenarios.replay``).

A success-bit trace packs 8 clients a byte, little-endian within the byte
(``np.packbits(..., bitorder="little")``); a lag trace packs 2 bits a client
("crumbs", 4 clients a byte, crumb ``j`` of byte ``b`` is client ``4*b +
j``), codes 0, 1, 2 for the lag and 3 for ``DEAD_LAG``.  The bytes are the
JAX package's, byte for byte, and so are the files: ``save_packed_trace``
writes ``<path>.npy`` and a ``<path>.meta.json`` sidecar ``{"kind":
"bits"|"lags", "K", "T", "clients_per_byte"}`` that either package reads.

``record_trace`` and ``record_lag_trace`` roll a model forward on the device
in chunks of rounds, packing each round's row there, so a chunk's packed
rows are all that cross to the host; a round's rows come from the JAX
package's keys (``core.prng``), so ``seed`` records the JAX package's trace.  ``ReplayVolatility`` and ``ReplayLag``
replay a trace through the draw protocol: the state is the round index, and
each round's row decodes through the kernel wrappers ``unpack_bits`` and
``unpack_crumbs``.  ``replay_packed_stream`` streams a saved trace from disk
through a ``carry_key`` runner, a chunk of rows at a time.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.prng import Key, PRNGKey, key_data, split
from repro_torch.core.volatility import DEAD_LAG, _Model
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import LAG_DEAD_CODE
from repro_torch.kernels.unpack_bits import unpack_bits, unpack_crumbs

__all__ = [
    "packed_width",
    "packed_nbytes",
    "pack_trace",
    "unpack_trace",
    "pack_bits_tensor",
    "record_trace",
    "ReplayVolatility",
    "lag_packed_width",
    "pack_lags",
    "unpack_lags",
    "pack_lags_tensor",
    "record_lag_trace",
    "ReplayLag",
    "save_packed_trace",
    "load_packed_trace",
    "replay_packed_stream",
]


def packed_width(K: int) -> int:
    """Bytes per packed round row: ceil(K / 8)."""
    return (K + 7) // 8


def packed_nbytes(T: int, K: int) -> int:
    """Total bytes of a packed (T, K) trace."""
    return T * packed_width(K)


def pack_trace(xs: np.ndarray) -> np.ndarray:
    """(..., K) {0,1} -> (..., ceil(K/8)) uint8, little-endian bit order."""
    return np.packbits(np.asarray(xs).astype(np.uint8), axis=-1, bitorder="little")


def unpack_trace(packed: np.ndarray, K: int) -> np.ndarray:
    """(..., B) uint8 -> (..., K) float32; inverse of ``pack_trace``."""
    bits = np.unpackbits(np.asarray(packed, np.uint8), axis=-1, bitorder="little")
    return bits[..., :K].astype(np.float32)


def _pack(codes: torch.Tensor, bits: int, pad_code: int) -> torch.Tensor:
    """``(..., K)`` uint8 codes of ``bits`` bits -> ``(..., ceil(K*bits/8))``
    uint8, code ``j`` of a byte at bit ``j*bits``; the tail padded with
    ``pad_code``."""
    per = 8 // bits
    K = codes.shape[-1]
    pad = (-K) % per
    if pad:
        codes = torch.cat([codes, codes.new_full((*codes.shape[:-1], pad), pad_code)], dim=-1)
    shifts = torch.arange(per, dtype=torch.uint8, device=codes.device) * bits
    groups = codes.reshape(*codes.shape[:-1], -1, per)
    return torch.sum(groups << shifts, dim=-1).to(torch.uint8)


def pack_bits_tensor(x: torch.Tensor) -> torch.Tensor:
    """On-device pack: (..., K) {0,1} float -> (..., ceil(K/8)) uint8."""
    return _pack(x.to(torch.uint8), 1, 0)


def _chunked_marginal(packed: np.ndarray, K: int, expand, T: int | None = None, chunk: int = 1024) -> np.ndarray:
    """Per-client mean of ``expand(rows) -> (n, K)`` over the first T packed
    rows, accumulated in row chunks so the dense trace never exists."""
    packed = np.asarray(packed)
    T = packed.shape[0] if T is None else T
    total = np.zeros(K, np.float64)
    chunk = max(1, min(chunk, T))
    for i in range(0, T, chunk):
        total += expand(packed[i : min(i + chunk, T)]).sum(0, dtype=np.float64)
    return (total / T).astype(np.float32)


def _record(model, T: int, seed: int, chunk: int, device, pack) -> np.ndarray:
    """Roll ``model`` forward ``T`` rounds on ``device`` on the JAX package's
    keys (``key, k2 = split(key)`` a round from ``PRNGKey(seed)``, the
    model's rows from ``k2``; the key carried on the device), pack each
    round with ``pack`` and copy the packed rows to the host a chunk at a
    time."""
    dev = resolve_device(device)
    model = model.to(dev)
    key = PRNGKey(seed, dev)
    vs = model.init_state()
    chunks, done = [], 0
    while done < T:
        n = min(chunk, T - done)
        rows = []
        for _ in range(n):
            key, k2 = split(key)
            out, vs = model.sample(model.draw(k2), vs)
            key = Key(key_data(key), partitionable=key.partitionable)  # carried with its path hashed in
            rows.append(pack(out))
        chunks.append(torch.stack(rows).cpu().numpy())
        done += n
    return np.concatenate(chunks)


def record_trace(vol, T: int, seed: int = 0, chunk: int = 256, device=None) -> np.ndarray:
    """Roll a success-bit model forward ``T`` rounds on ``device`` and return
    the packed ``(T, ceil(K/8))`` uint8 trace; the device holds one chunk of
    packed rows at a time."""
    return _record(vol, T, seed, chunk, device, pack_bits_tensor)


@dataclass(frozen=True)
class ReplayVolatility(_Model):
    """Replay a packed 1-bit trace: the state is the round index, and row
    ``t`` decodes through ``unpack_bits``.  Rounds past the end repeat the
    last row; size the trace to the horizon."""

    packed: torch.Tensor  # (T, ceil(K/8)) uint8
    K: int

    @property
    def rho(self) -> torch.Tensor:
        """Empirical marginal of the trace (the fedcs hint)."""
        rho = _chunked_marginal(self.packed.cpu().numpy(), self.K, lambda rows: unpack_trace(rows, self.K))
        return torch.as_tensor(rho, device=self.packed.device)

    def init_state(self):
        return torch.zeros((), dtype=torch.int32, device=self.packed.device)

    def draw_rows(self):
        return ()

    def key_paths(self):
        return ()

    def sample(self, us, state):
        return unpack_bits(_row(self.packed, state), self.K), state + 1


def _row(packed: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Row ``t`` of a trace on the device, clamped into the trace."""
    i = torch.clamp(t, 0, packed.shape[0] - 1).reshape(1).long()
    return torch.index_select(packed, 0, i)[0]


def lag_packed_width(K: int) -> int:
    """Bytes per packed lag row: ceil(K / 4) at 2 bits per client."""
    return (K + 3) // 4


def _lag_codes(lags: np.ndarray) -> np.ndarray:
    """int32 lags {0, 1, 2, DEAD_LAG} -> uint8 crumb codes {0, 1, 2, 3}."""
    lags = np.asarray(lags)
    if ((lags > 2) | ((lags < 0) & (lags != DEAD_LAG))).any():
        raise ValueError("2-bit lag traces hold lags {0, 1, 2} and DEAD_LAG only; record with max_lag <= 2")
    return np.where(lags < 0, LAG_DEAD_CODE, lags).astype(np.uint8)


def pack_lags(lags: np.ndarray) -> np.ndarray:
    """(..., K) int32 lags in {0, 1, 2, DEAD_LAG} -> (..., ceil(K/4)) uint8."""
    codes = _lag_codes(lags)
    K = codes.shape[-1]
    pad = (-K) % 4
    if pad:  # pad with dead clients, never decoded past K
        codes = np.concatenate([codes, np.full((*codes.shape[:-1], pad), LAG_DEAD_CODE, np.uint8)], axis=-1)
    quads = codes.reshape(*codes.shape[:-1], -1, 4).astype(np.uint16)
    shifts = np.arange(4, dtype=np.uint16) * 2
    return np.bitwise_or.reduce(quads << shifts, axis=-1).astype(np.uint8)


def unpack_lags(packed: np.ndarray, K: int) -> np.ndarray:
    """(..., B) uint8 -> (..., K) int32 lags; inverse of ``pack_lags``."""
    packed = np.asarray(packed, np.uint8)
    shifts = np.arange(4, dtype=np.uint8) * 2
    codes = (packed[..., None] >> shifts) & 3
    codes = codes.reshape(*packed.shape[:-1], packed.shape[-1] * 4)[..., :K].astype(np.int32)
    return np.where(codes == LAG_DEAD_CODE, DEAD_LAG, codes)


def pack_lags_tensor(lag: torch.Tensor) -> torch.Tensor:
    """On-device lag pack: (..., K) int32 -> (..., ceil(K/4)) uint8.  Codes
    are clamped into 2 bits so a lag past 2 cannot spill into a neighbour's
    crumb; ``record_lag_trace`` detects such lags and raises."""
    codes = torch.where(lag < 0, torch.full_like(lag, LAG_DEAD_CODE), torch.clamp(lag, max=2)).to(torch.uint8)
    return _pack(codes, 2, LAG_DEAD_CODE)


def record_lag_trace(lag_model, T: int, seed: int = 0, chunk: int = 256, device=None) -> np.ndarray:
    """Roll a lag model forward ``T`` rounds on ``device``; returns the
    packed ``(T, ceil(K/4))`` uint8 crumb trace.  Lags past 2 do not fit 2
    bits: build the model with ``max_lag <= 2``; a model that still emits
    one raises once the trace is recorded."""
    max_lag = getattr(lag_model, "max_lag", None)
    if max_lag is not None and max_lag > 2:
        raise ValueError(f"2-bit lag traces hold lags up to 2; model has max_lag={max_lag}")
    flags = []

    def pack(lag):
        flags.append(torch.any(lag > 2))
        return pack_lags_tensor(lag)

    out = _record(lag_model, T, seed, chunk, device, pack)
    if flags and bool(torch.stack(flags).any()):
        raise ValueError("lag model emitted a lag > 2; 2-bit traces cannot represent it")
    return out


@dataclass(frozen=True)
class ReplayLag(_Model):
    """Replay a packed 2-bit lag trace through the lag protocol (int32 lags:
    0 on time, 1-2 late, ``DEAD_LAG`` never): the state is the round index,
    and row ``t`` decodes through ``unpack_crumbs``."""

    packed: torch.Tensor  # (T, ceil(K/4)) uint8
    K: int

    @property
    def rho(self) -> torch.Tensor:
        """Empirical on-time marginal of the trace."""
        rho = _chunked_marginal(self.packed.cpu().numpy(), self.K, lambda rows: unpack_lags(rows, self.K) == 0)
        return torch.as_tensor(rho, device=self.packed.device)

    def init_state(self):
        return torch.zeros((), dtype=torch.int32, device=self.packed.device)

    def draw_rows(self):
        return ()

    def key_paths(self):
        return ()

    def sample(self, us, state):
        codes = unpack_crumbs(_row(self.packed, state), self.K)
        return torch.where(codes == LAG_DEAD_CODE, torch.full_like(codes, DEAD_LAG), codes), state + 1


def save_packed_trace(path: str, packed: np.ndarray, K: int, kind: str = "bits") -> str:
    """Write a packed trace as ``<path>.npy`` + ``<path>.meta.json``;
    ``kind`` is ``"bits"`` (8 clients a byte) or ``"lags"`` (4 a byte).
    Returns the array's path."""
    if kind not in ("bits", "lags"):
        raise ValueError(f"unknown trace kind {kind!r} (want 'bits' or 'lags')")
    packed = np.asarray(packed, np.uint8)
    want = packed_width(K) if kind == "bits" else lag_packed_width(K)
    if packed.ndim != 2 or packed.shape[1] != want:
        raise ValueError(f"{kind} trace for K={K} must be (T, {want}) uint8, got {packed.shape}")
    base = path[:-4] if path.endswith(".npy") else path
    np.save(base + ".npy", packed)
    meta = {"kind": kind, "K": int(K), "T": int(packed.shape[0]), "clients_per_byte": 8 if kind == "bits" else 4}
    with open(base + ".meta.json", "w") as f:
        json.dump(meta, f)
    return base + ".npy"


def load_packed_trace(path: str, mmap: bool = True):
    """Reopen a saved trace: ``(array, meta)``, the array an ``np.memmap``
    (``mmap=True``) whose rows page in as a replay touches them."""
    base = path[:-4] if path.endswith(".npy") else path
    with open(base + ".meta.json") as f:
        meta = json.load(f)
    arr = np.load(base + ".npy", mmap_mode="r" if mmap else None)
    if arr.shape[0] != meta["T"]:
        raise ValueError(f"trace length {arr.shape[0]} disagrees with sidecar T={meta['T']}")
    return arr, meta


def replay_packed_stream(
    scheme: str,
    path: str,
    k: int,
    T: int | None = None,
    chunk: int = 512,
    quota: str = "const",
    frac: float = 0.0,
    eta: float = 0.5,
    seed: int = 0,
    rho=None,
    staleness: int | None = None,
    alpha: float = 0.5,
    feedback: str = "deadline",
    taps: bool = False,
    device=None,
):
    """Replay a saved packed trace through a ``carry_key`` runner in
    ``chunk``-round pieces, each copied to the device on its own, so the
    horizon streams from disk.

    A ``"bits"`` trace replays through the synchronous round, a ``"lags"``
    trace through the async round (``staleness`` defaults to 2, the most a
    2-bit trace holds).  The noise is the JAX package's from
    ``PRNGKey(seed)``; the state, the key and (async) the rings carry across
    chunks, so a chunked replay equals a one-shot one.
    Returns the lean outputs as numpy (per-round scalars and final counts;
    async adds ``on_time``, ``stale`` and ``cep``; ``rho`` when it was
    computed (``fedcs``) or supplied); ``taps=True`` adds ``"taps"``
    (``{"series", "counters"}``, the chunks' series joined).
    """
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.volatility import make_volatility
    from repro_torch.engine.round_program import RoundProgram
    from repro_torch.obs.taps import ROUND_TAPS

    dev = resolve_device(device)
    packed, meta = load_packed_trace(path)
    is_lags = meta["kind"] == "lags"
    if is_lags:
        staleness = 2 if staleness is None else int(staleness)
    elif staleness is not None:
        raise ValueError("staleness applies to 'lags' traces; this trace holds success bits")
    K = meta["K"]
    T = meta["T"] if T is None else min(int(T), meta["T"])
    chunk = min(chunk, T)
    if rho is None and scheme == "fedcs":
        expand = (lambda rows: unpack_lags(rows, K) == 0) if is_lags else (lambda rows: unpack_trace(rows, K))
        rho = _chunked_marginal(packed, K, expand, T=T)
    rho_out = rho
    if rho is None:
        rho = np.zeros(K, np.float32)  # inert for every non-fedcs scheme
    rho = np.asarray(rho.cpu() if torch.is_tensor(rho) else rho, np.float32)
    fl = FLConfig(K=K, k=k, rounds=T, scheme=scheme, quota=quota, quota_frac=frac, eta=eta)
    vol = make_volatility("bernoulli", rho, device=dev)  # placeholder state; outcomes come from the trace
    program = RoundProgram(
        fl=fl, vol=vol, rho=rho, override="packed_lags" if is_lags else "packed",
        staleness=staleness, alpha=alpha, feedback=feedback, device=dev,
    )
    run, state = program.build_runner(outputs="lean", carry_key=True, scan_length=chunk, taps=taps)
    run_tail = (
        program.build_runner(outputs="lean", carry_key=True, scan_length=T % chunk, taps=taps)[0]
        if T % chunk
        else None
    )
    key = PRNGKey(seed, dev)
    carried = ((program.init_rings(),) if is_lags else ()) + ((ROUND_TAPS.init_counters(dev),) if taps else ())
    cols, rows = [], []
    for lo in range(0, T, chunk):
        hi = min(lo + chunk, T)
        step_run = run if hi - lo == chunk else run_tail
        xs = torch.from_numpy(np.array(packed[lo:hi])).to(dev)  # one chunk of rows on the device
        state, key, *res = step_run(state, key, *carried, xs)
        carried, outs = tuple(res[: len(carried)]), res[len(carried):]
        if taps:
            *outs, row = outs
            rows.append(row)
        cols.append([o.cpu().numpy() for o in outs])
    joined = [np.concatenate(c) for c in zip(*cols)]
    counts = state.sel_counts.cpu().numpy()
    if is_lags:
        on_time, stale, sigmas = joined
        out = {"on_time": on_time, "stale": stale, "sigmas": sigmas, "counts": counts, "cep": float(state.cep)}
    else:
        successes, sigmas = joined
        out = {"successes": successes, "sigmas": sigmas, "counts": counts}
    if rho_out is not None:
        out["rho"] = np.asarray(rho_out.cpu() if torch.is_tensor(rho_out) else rho_out)
    if taps:
        out["taps"] = {
            "series": {n: np.concatenate([r[n].cpu().numpy() for r in rows]) for n in rows[0]},
            "counters": {n: float(v) for n, v in carried[-1].items()},
        }
    return out

"""The threefry kernel's wrapper (``csrc/threefry.cu``): JAX's threefry2x32
hash over a run of counters, under a key folded by up to four integers, with
an epilogue by mode (``kernels.ref.threefry_ref`` says what each writes).
``core.prng`` builds the JAX key stream on it.

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it takes
the plain version, ``threefry_ref``.  Its launches are counted by mode
(``LAUNCHES``; ``kernels.launch_counts`` reports ``threefry.<mode>``): each
epilogue is a kernel of its own.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from ._build import check, launch, ptr, route
from .ref import THREEFRY_MODES, threefry_ref

__all__ = ["threefry", "MAX_PATH", "LAUNCHES"]

MAX_PATH = 4  # folds a launch takes (the kernel's Path)
_DTYPE = {"keys": torch.int32, "bits": torch.int32, "sortkey": torch.int32, "uniform": torch.float32,
          "gumbel": torch.float32}
LAUNCHES = {mode: SimpleNamespace(launches=0) for mode in THREEFRY_MODES}  # a count a mode


def threefry(key: torch.Tensor, path: tuple, offset: int, n: int, mode: str, minval: float = 0.0,
             maxval: float = 1.0, out: torch.Tensor = None) -> torch.Tensor:
    """``n`` hashes of counters ``offset ..`` under ``key`` (a ``(2,)`` int32
    tensor of uint32 words) folded by ``path``: ``(n, 2)`` int32 key pairs
    (``"keys"``), ``(n,)`` int32 bits (``"bits"``, ``"sortkey"``) or float32
    (``"uniform"`` in ``[minval, maxval)``, ``"gumbel"``).  ``out``, when
    given, receives them; with ``"keys"`` and ``n = 1`` it may be ``key``
    itself (one block reads the key before any thread writes)."""
    if mode not in THREEFRY_MODES:
        raise ValueError(f"unknown threefry mode {mode!r} (want one of {THREEFRY_MODES})")
    if len(path) > MAX_PATH:
        raise ValueError(f"a launch folds at most {MAX_PATH} integers, got {len(path)}")
    shape = (n, 2) if mode == "keys" else (n,)
    if not route(key):
        res = threefry_ref(key, path, offset, n, mode, minval, maxval)
        return res if out is None else out.copy_(res.reshape(out.shape))
    check(key, "threefry key", torch.int32, (2,), key.device)
    if out is None:
        out = torch.empty(shape, dtype=_DTYPE[mode], device=key.device)
    elif out.dtype != _DTYPE[mode] or out.numel() != n * (2 if mode == "keys" else 1) or not out.is_contiguous() \
            or out.device != key.device:
        raise ValueError(f"threefry {mode}: want a contiguous {_DTYPE[mode]} out of {n} rows on {key.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if mode == "keys" and out.data_ptr() % 8:
        raise ValueError("threefry keys: out must be 8-byte aligned (one uint2 store a pair)")
    if out.data_ptr() == key.data_ptr() and not (mode == "keys" and n == 1):
        raise ValueError("threefry: out may be the key itself only for one key pair")
    d = [int(v) for v in path] + [0] * (MAX_PATH - len(path))
    launch("repro_threefry", key.device, ptr(key), len(path), *d, int(offset), int(n), THREEFRY_MODES.index(mode),
           float(minval), float(maxval), ptr(out))
    LAUNCHES[mode].launches += 1
    return out

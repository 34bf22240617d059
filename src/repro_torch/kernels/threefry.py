"""The threefry kernel's wrapper (``csrc/threefry.cu``): JAX's threefry2x32
hash over a run of counters, under a key folded by up to four integers, with
an epilogue by mode (``kernels.ref.threefry_ref`` says what each writes).
``core.prng`` builds the JAX key stream on it.  ``threefry_rows`` hashes J
Gumbel rows under J keys in one launch, and ``threefry_categorical`` draws JAX's
``categorical`` over ``(B, V)`` logits in one launch, the noise never
written.

Each entry also takes JAX's original layout (``jax_threefry_partitionable=
False``; ``total`` for ``threefry``, ``original`` for the other two; see
``threefry_ref``), a second counter layout of the same kernel.

On a CUDA tensor each launches the kernel or raises; on a CPU tensor it
takes the plain version (``threefry_ref``, ``threefry_rows_ref``,
``categorical_ref``).  Launches are counted by mode, and the rows and
categorical entries each by their own name, the original layout's apart
(``LAUNCHES``; ``kernels.launch_counts`` reports ``threefry.<mode>``,
``threefry.rows``, ``threefry.categorical`` and the same names under
``threefry.original.``): each is a kernel of its own.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from ._build import check, launch, ptr, route
from .ref import THREEFRY_MODES, categorical_ref, threefry_ref, threefry_rows_ref

__all__ = ["threefry", "threefry_rows", "threefry_categorical", "MAX_PATH", "LAUNCHES"]

MAX_PATH = 4  # folds a launch takes (the kernel's Path)
_DTYPE = {"keys": torch.int32, "bits": torch.int32, "sortkey": torch.int32, "uniform": torch.float32,
          "gumbel": torch.float32, "normal": torch.float32}
# a count a mode, and one for each of the rows and categorical entries, each
# again for the original layout
_ENTRIES = THREEFRY_MODES + ("rows", "categorical")
LAUNCHES = {name: SimpleNamespace(launches=0) for name in _ENTRIES + tuple(f"original.{e}" for e in _ENTRIES)}
_WORDS = 2**32 - 1  # JAX draws this many original-layout words or more in blocks under split keys


def _count(entry: str, original: bool) -> None:
    LAUNCHES[f"original.{entry}" if original else entry].launches += 1


def _folds(path: tuple) -> list:
    if len(path) > MAX_PATH:
        raise ValueError(f"a launch folds at most {MAX_PATH} integers, got {len(path)}")
    return [len(path)] + [int(v) for v in path] + [0] * (MAX_PATH - len(path))


def _check_original(what: str, words: int) -> None:
    """The rows and categorical entries take one original-layout draw under
    their key: a row or a logits array of 2**32 - 1 words (16 GB) or more,
    which JAX draws in blocks under split keys, is refused."""
    if words >= _WORDS:
        raise ValueError(f"{what}: a draw of {words} words in the original layout; this entry draws fewer than "
                         "2**32 - 1 (JAX's blocked draws are the threefry entry's)")


def threefry(key: torch.Tensor, path: tuple, offset: int, n: int, mode: str, minval: float = 0.0,
             maxval: float = 1.0, out: torch.Tensor = None, total: int = 0) -> torch.Tensor:
    """``n`` hashes of counters ``offset ..`` under ``key`` (a ``(2,)`` int32
    tensor of uint32 words) folded by ``path``: ``(n, 2)`` int32 key pairs
    (``"keys"``), ``(n,)`` int32 bits (``"bits"``, ``"sortkey"``) or float32
    (``"uniform"`` in ``[minval, maxval)``, ``"gumbel"``).  ``total > 0``:
    the values ``offset .. offset + n - 1`` of a draw of ``total`` in the
    original layout instead (a draw of ``2**32 - 1`` words or more in JAX's
    blocks under split keys; a split, ``"keys"``, of fewer words, as JAX's
    original split).  ``out``, when given, receives them; with
    ``"keys"``, ``n = 1`` and ``total = 0`` it may be ``key`` itself (one
    block reads the key before any thread writes)."""
    if mode not in THREEFRY_MODES:
        raise ValueError(f"unknown threefry mode {mode!r} (want one of {THREEFRY_MODES})")
    folds = _folds(path)
    shape = (n, 2) if mode == "keys" else (n,)
    if total:
        if not 0 <= offset <= offset + n <= total:
            raise ValueError(f"threefry {mode}: values {offset} .. {offset + n} are not in a draw of {total}")
        if mode == "keys" and 2 * total > _WORDS:
            raise ValueError(f"threefry keys: split({total}) in the original layout is a draw of {2 * total} words; "
                             "JAX's original split draws at most 2**32 - 1")
    if not route(key):
        res = threefry_ref(key, path, offset, n, mode, minval, maxval, total=total)
        return res if out is None else out.copy_(res.reshape(out.shape))
    check(key, "threefry key", torch.int32, (2,), key.device)
    if out is None:
        out = torch.empty(shape, dtype=_DTYPE[mode], device=key.device)
    elif out.dtype != _DTYPE[mode] or out.numel() != n * (2 if mode == "keys" else 1) or not out.is_contiguous() \
            or out.device != key.device:
        raise ValueError(f"threefry {mode}: want a contiguous {_DTYPE[mode]} out of {n} rows on {key.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if mode == "keys" and not total and out.data_ptr() % 8:
        raise ValueError("threefry keys: out must be 8-byte aligned (one uint2 store a pair)")
    if out.data_ptr() == key.data_ptr() and not (mode == "keys" and n == 1 and not total):
        raise ValueError("threefry: out may be the key itself only for one key pair in the partitionable layout")
    launch("repro_threefry", key.device, ptr(key), *folds, int(offset), int(n), int(total),
           THREEFRY_MODES.index(mode), float(minval), float(maxval), ptr(out))
    _count(mode, bool(total))
    return out


def threefry_rows(keys: torch.Tensor, path: tuple, n: int, out: torch.Tensor = None,
                  original: bool = False) -> torch.Tensor:
    """``(J, n)`` float32: row ``j`` is ``threefry(keys[j], path, 0, n,
    "gumbel")`` (``keys`` a ``(J, 2)`` int32 tensor of key words on the
    device), or with ``original`` the same with ``total=n``, all J rows in
    one launch; into ``out`` when given."""
    folds = _folds(path)
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"threefry rows: want (J, 2) keys, got {tuple(keys.shape)}")
    J = keys.shape[0]
    if original:
        _check_original("threefry rows", n)
    if not route(keys):
        res = threefry_rows_ref(keys, path, n, original=original)
        return res if out is None else out.copy_(res)
    check(keys, "threefry rows keys", torch.int32, (J, 2), keys.device)
    if out is None:
        out = torch.empty((J, n), dtype=torch.float32, device=keys.device)
    else:
        check(out, "threefry rows out", torch.float32, (J, n), keys.device)
    launch("repro_threefry_rows", keys.device, ptr(keys), J, *folds, int(n), int(original), ptr(out))
    _count("rows", original)
    return out


def threefry_categorical(key: torch.Tensor, path: tuple, logits: torch.Tensor, original: bool = False) -> torch.Tensor:
    """JAX's ``categorical(key, logits)`` over the last axis of ``(B, V)``
    float32 or bfloat16 logits, ``key`` folded by ``path``: the ``(B,)``
    int32 argmax of Gumbel noise plus logits, ties to the lowest index, in
    one launch (``categorical_ref`` is its plain version); ``original``: the
    noise in the original layout.  The launch's blocks meet in a scratch of
    the library's own, which its last block leaves reset: calls on one
    device run in stream order (two streams at once would share it)."""
    folds = _folds(path)
    if logits.dim() != 2 or logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"categorical: want (B, V) float32 or bfloat16 logits, got {logits.dtype} "
                         f"{tuple(logits.shape)}")
    if original:
        n = logits.numel()
        _check_original("categorical", -(-n // 4) if logits.dtype == torch.bfloat16 else n)
    if not route(key):
        return categorical_ref(key, path, logits, original=original)
    check(key, "categorical key", torch.int32, (2,), key.device)
    B, V = logits.shape
    check(logits, "categorical logits", logits.dtype, (B, V), key.device)
    out = torch.empty(B, dtype=torch.int32, device=key.device)
    launch("repro_threefry_categorical", key.device, ptr(key), *folds, ptr(logits), int(B), int(V),
           int(logits.dtype == torch.bfloat16), int(original), ptr(out))
    _count("categorical", original)
    return out

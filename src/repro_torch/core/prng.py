"""The JAX package's key stream in the port: a twin of jax 0.9's threefry PRNG
(``jax._src.prng`` and ``jax._src.random``) in both of its modes, so the same
seed gives the port the same noise.

A key is two uint32 words, held as a ``(2,)`` int32 tensor on a device
(``Key``), so a runner carries and advances it on the device.  Everything is
the threefry2x32 hash of a counter under a key (``kernels.threefry``: a CUDA
kernel on the card, ``kernels.ref.threefry_ref`` on the CPU):

* ``PRNGKey(seed)`` is ``(0, seed mod 2**32)`` (``threefry_seed``, the seed
  taken as JAX's int32 of it);
* ``fold_in(key, d)`` hashes the counter ``(0, d)`` in either mode;
* a ``Key`` carries its mode, JAX's ``jax_threefry_partitionable``, and every
  key derived from it keeps it.  ``PRNGKey`` takes the port's current
  default: partitionable, jax 0.9's default, or what the innermost
  ``threefry_partitionable(flag)`` block says (the port's copy of JAX's
  config flag, so the entry points taking an int seed follow it as JAX's
  follow JAX's);
* partitionable mode: ``split(key, n)[i]`` hashes ``(0, i)``
  (``_threefry_split_foldlike``), the same key as ``fold_in(key, i)``, so a
  ``Key`` keeps its folds as a ``path`` and the kernel applies them once a
  block, where the key is used; ``random_bits(key, shape)`` hashes the flat
  index ``i`` as ``(i >> 32, i & 0xFFFFFFFF)`` into ``(a, b)`` and keeps
  ``a ^ b`` (``_threefry_random_bits_partitionable``);
* original mode (``jax_threefry_partitionable=False``): a draw of ``m``
  words hashes the counter pairs ``(j, j + h)``, ``h = ceil(m / 2)``, word
  ``j`` the first output and word ``j + h`` the second, an odd draw's
  padded counter's output dropped (``threefry_2x32``); ``random_bits`` is
  the draw of ``n`` words and ``split(key, n)`` the draw of ``2n`` words,
  key ``i`` words ``2i`` and ``2i + 1`` (``_threefry_split_original``), so a
  split is materialised, its ``n`` keys in one launch; 8-bit draws (the
  bfloat16 Gumbel) take four values out of each word;
* ``uniform``, ``gumbel`` (mode ``"low"``), ``bernoulli``, ``exponential``,
  ``permutation`` (``_shuffle``: sorts by fresh 32-bit keys, stable),
  ``normal`` (``sqrt(2) * erf_inv(u)``, ``u`` uniform in ``[nextafter(-1,
  0), 1)``, XLA's float32 ``erf_inv``), ``randint`` (two 32-bit words, the
  high and low, reduced by the span with JAX's ``2**16 % span`` multiplier)
  and ``categorical`` (``argmax(gumbel + logits)``, one fused launch) are
  ``jax.random``'s transforms of those bits;
* ``split_data`` and ``rows`` serve J keys at once: ``split(key, J)`` as
  ``Keys`` (the ``(J, 2)`` words and their mode), and J rows each under its
  own key folded by a shared path, in one launch (a fleet's per-job Gumbel
  rows); ``derive`` walks a path of folds and splits (a model's
  ``key_paths``).

Bits, keys, uniforms, permutations and ``randint`` equal JAX's exactly;
Gumbel and exponential rows equal them up to the last bit of a ``log``
(ATen's and XLA's differ by at most one ulp), and so ``categorical`` equals
JAX's given equal logits but where two columns' scores lie within that bit
of each other (bfloat16 logits take JAX's 8-bit bfloat16 Gumbel, whose 128
values equal JAX's).  ``normal`` is within 3 ulps of JAX's
(``tests/test_torch_prng_dists.py`` sweeps every value it can take): the
polynomial is XLA's, its multiply-adds fused as XLA fuses them on the CPU,
but ``log1p`` is ATen's (or CUDA's), not XLA's.  An original-mode draw of
``2**32 - 1`` words or more is JAX's blocked draw: the key split into
``nblocks + 1`` keys, each full block of ``2**32 - 1`` words under its own
(``kernels.ref._original``); a block of such a draw (``normal``'s
``start`` and ``total``) draws only its words.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.threefry import MAX_PATH, threefry, threefry_categorical, threefry_rows

__all__ = [
    "Key",
    "Keys",
    "PRNGKey",
    "threefry_partitionable",
    "default_partitionable",
    "derive",
    "key_data",
    "fold_in",
    "split",
    "random_bits",
    "uniform",
    "gumbel",
    "bernoulli",
    "exponential",
    "permutation",
    "normal",
    "randint",
    "categorical",
    "split_data",
    "rows",
    "advance_",
]

_M32 = 0xFFFFFFFF
_DEFAULT = [True]  # the mode a key takes when none is given (threefry_partitionable)


def default_partitionable() -> bool:
    """The mode a key takes when none is given: ``True`` (jax 0.9's
    default) but inside ``threefry_partitionable(False)``."""
    return _DEFAULT[-1]


@contextlib.contextmanager
def threefry_partitionable(flag: bool):
    """Within the block, keys made without a mode (``PRNGKey(seed)``, a
    ``Key`` of raw words) take ``flag``: the port's ``jax.threefry_partitionable``.
    A key keeps the mode it was made with after the block."""
    _DEFAULT.append(bool(flag))
    try:
        yield
    finally:
        _DEFAULT.pop()


class Key:
    """A JAX threefry key on a device: ``data``, a ``(2,)`` int32 tensor of
    its two uint32 words, folded by each integer of ``path`` in turn (not
    yet hashed), in the mode ``partitionable`` (``None``: the current
    default).  ``key_data`` hashes the path in."""

    __slots__ = ("data", "path", "partitionable")

    def __init__(self, data: torch.Tensor, path: Tuple[int, ...] = (), partitionable: Optional[bool] = None):
        if data.dtype != torch.int32 or tuple(data.shape) != (2,):
            raise ValueError(f"a key's data is a (2,) int32 tensor, got {data.dtype} {tuple(data.shape)}")
        self.data, self.path = data, tuple(int(d) for d in path)
        self.partitionable = default_partitionable() if partitionable is None else bool(partitionable)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __repr__(self) -> str:
        return f"Key({self.data.tolist()}, path={self.path}, partitionable={self.partitionable})"


def _words(seed: int) -> Tuple[int, int]:
    return 0, int(np.int64(seed).astype(np.int32)) & _M32


def PRNGKey(seed: int, device=None, partitionable: Optional[bool] = None) -> Key:
    """JAX's ``PRNGKey(seed)`` on ``device`` (``None``: CUDA): the words
    ``(0, seed)``, the seed taken as JAX takes a Python int under 32-bit
    types (its low 32 bits), in the mode ``partitionable`` (``None``: the
    current default, ``threefry_partitionable``)."""
    w = [v - 2**32 if v >= 2**31 else v for v in _words(seed)]
    return Key(torch.tensor(w, dtype=torch.int32, device=resolve_device(device)), partitionable=partitionable)


def key_data(key: Key) -> torch.Tensor:
    """The key's two words as a ``(2,)`` int32 tensor: its path hashed in
    (one launch), or its data as it is when the path is empty."""
    if not key.path:
        return key.data
    return threefry(key.data, key.path[:-1], key.path[-1], 1, "keys").view(2)


def _flat(key: Key) -> Key:
    """``key`` with a path the kernel takes in one launch."""
    if len(key.path) <= MAX_PATH:
        return key
    return Key(key_data(Key(key.data, key.path[:MAX_PATH])), key.path[MAX_PATH:], key.partitionable)


def fold_in(key: Key, d: int) -> Key:
    """JAX's ``fold_in(key, d)`` (``d`` a host int, taken as uint32): the
    same hash in both modes."""
    return _flat(Key(key.data, key.path + (int(d) & _M32,), key.partitionable))


def advance_(words: torch.Tensor) -> torch.Tensor:
    """A carried partitionable key's ``(2,)`` int32 words replaced, in place
    and in one launch, by those of ``split(key)[0]`` (``fold_in(key, 0)``:
    the key a JAX loop carries on after ``key, sub = split(key)``).  In the
    original mode a carried key takes its round's split instead
    (``round_program.JaxStream``)."""
    threefry(words, (), 0, 1, "keys", out=words.view(1, 2))
    return words


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """JAX's ``split(key, num)`` in the key's mode: partitionable, key ``i``
    is ``fold_in(key, i)`` (no launch); original, the ``num`` keys of one
    launch (``split_data``)."""
    if key.partitionable:
        return tuple(fold_in(key, i) for i in range(int(num)))
    return tuple(Key(w, partitionable=False) for w in split_data(key, num).data.unbind(0))


def derive(key: Key, path) -> Key:
    """The key at the end of ``path`` from ``key``: an int ``d`` is
    ``fold_in(key, d)``, a pair ``(i, n)`` is ``split(key, n)[i]``."""
    for step in path:
        key = split(key, step[1])[step[0]] if isinstance(step, tuple) else fold_in(key, step)
    return key


def _n(shape) -> Tuple[tuple, int]:
    shape = (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)
    return shape, math.prod(shape)


def _draw(key: Key, shape, mode: str, minval: float = 0.0, maxval: float = 1.0, out=None,
          start: int = 0, total: Optional[int] = None) -> torch.Tensor:
    shape, n = _n(shape)
    key = _flat(key)
    if key.partitionable:
        total = 0
    elif total is None:
        if start:
            raise ValueError("a block of an original-mode draw needs the draw's total")
        total = n
    res = threefry(key.data, key.path, start, n, mode, minval, maxval, out=None if out is None else out.view(-1),
                   total=total)
    return res.view(shape)


def random_bits(key: Key, shape) -> torch.Tensor:
    """JAX's 32-bit ``random_bits``: int64 values in ``[0, 2**32)``."""
    return _draw(key, shape, "bits").to(torch.int64) & _M32


def uniform(key: Key, shape=(), minval: float = 0.0, maxval: float = 1.0, out=None) -> torch.Tensor:
    """JAX's float32 ``uniform(key, shape, minval=, maxval=)`` (into ``out``
    when given)."""
    return _draw(key, shape, "uniform", minval, maxval, out)


def gumbel(key: Key, shape=(), out=None) -> torch.Tensor:
    """JAX's float32 ``gumbel(key, shape)``, mode ``"low"``: ``-log(-log(u))``
    of ``u`` uniform in ``[tiny, 1)``."""
    return _draw(key, shape, "gumbel", out=out)


def bernoulli(key: Key, p, shape=None) -> torch.Tensor:
    """JAX's ``bernoulli(key, p)``: ``uniform(key, shape) < p`` (a bool
    tensor of ``p``'s shape, or ``shape``)."""
    p = torch.as_tensor(p, dtype=torch.float32, device=key.device)
    return uniform(key, tuple(p.shape) if shape is None else shape) < p


def exponential(key: Key, shape=()) -> torch.Tensor:
    """JAX's float32 ``exponential(key, shape)``: ``-log1p(-u)``."""
    return -torch.log1p(-uniform(key, shape))


def _permutation_rounds(n: int) -> int:
    """The sorts of JAX's ``_shuffle`` over ``n`` elements:
    ``ceil(3 ln n / ln(2**32 - 1))``."""
    return int(np.ceil(3 * np.log(max(1, int(n))) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: Key, n: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's ``permutation(key, n)`` as int64: each round splits the key,
    draws 32-bit sort keys from the second half and sorts the running
    permutation by them, stably (into ``out`` when given)."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(_permutation_rounds(n)):
        key, sub = split(key)
        order = torch.sort(_draw(sub, (n,), "sortkey"), stable=True).indices
        x = x[order]
    return x if out is None else out.copy_(x)


def normal(key: Key, shape=(), out=None, start: int = 0, total: Optional[int] = None) -> torch.Tensor:
    """JAX's float32 ``normal(key, shape)``: ``sqrt(2) * erf_inv(u)`` of
    ``u`` uniform in ``[nextafter(-1, 0), 1)`` (into ``out`` when given).
    ``start`` draws the flat elements ``start ..`` of a larger draw under the
    same key, of ``total`` elements in all (the original mode's layout
    depends on it): a block of a tensor too large to draw at once."""
    return _draw(key, shape, "normal", out=out, start=start, total=total)


_INT_DTYPES = {torch.int8: 8, torch.int16: 16, torch.int32: 32}


def randint(key: Key, shape, minval: int, maxval: int, dtype=torch.int32) -> torch.Tensor:
    """JAX's ``randint(key, shape, minval, maxval, dtype)`` for int8, int16
    and int32 (host int bounds): ``k1, k2 = split(key)``, 32 high and 32 low
    bits, each reduced by the span, joined with the multiplier ``(2**16 %
    span)**2 % span`` and reduced again, all in uint32 arithmetic; the
    bounds are clamped to the dtype (a narrower type samples in int32 with
    its bounds clipped first, then casts)."""
    if dtype not in _INT_DTYPES:
        raise ValueError(f"randint takes int8, int16 or int32, got {dtype}")
    info = torch.iinfo(dtype)
    minval, maxval = int(minval), int(maxval)
    if _INT_DTYPES[dtype] < 32:  # sampled in int32, the bounds clipped to the narrow type
        minval, maxval = min(max(minval, info.min), info.max), min(max(maxval, info.min), info.max + 1)
    i32 = torch.iinfo(torch.int32)
    out_of_range = maxval > i32.max
    lo, hi = min(max(minval, i32.min), i32.max), min(max(maxval, i32.min), i32.max)
    span = (hi - lo) & _M32
    if hi <= lo:
        span = 1
    elif out_of_range:
        span = (span + 1) & _M32
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    if span == 0:  # the whole 32-bit range: XLA's x % 0 is x, and the multiplier wraps to 0
        offset = lower
    else:
        mult = (((2**16 % span) ** 2) & _M32) % span  # uint32: 2**32 wraps to 0
        a = higher % span  # a * mult mod 2**32 in two halves of mult, each product below 2**48
        prod = ((((a * (mult >> 16)) & _M32) << 16) + a * (mult & 0xFFFF)) & _M32
        offset = ((prod + lower % span) & _M32) % span
    v = (lo + offset) & _M32
    v = torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)
    return v.to(dtype)


def categorical(key: Key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """JAX's ``categorical(key, logits)`` along the last axis, with
    replacement and the default shape: int32 ``argmax(gumbel(key,
    logits.shape, logits.dtype) + logits, -1)``, ties to the lowest index,
    for float32 or bfloat16 logits.  One launch over the rows; the noise is
    never written."""
    if axis not in (-1, logits.dim() - 1):
        raise ValueError("categorical draws along the last axis only")
    key = _flat(key)
    V = logits.shape[-1]
    out = threefry_categorical(key.data, key.path, logits.reshape(-1, V).contiguous(), original=not key.partitionable)
    return out.view(logits.shape[:-1])


class Keys(NamedTuple):
    """J keys in one mode: ``data``, their words as a ``(J, 2)`` int32
    tensor on a device, and ``partitionable``, the mode of the key they
    were split from (``split_data``; ``rows`` takes them)."""

    data: torch.Tensor
    partitionable: bool


def split_data(key: Key, num: int) -> Keys:
    """``split(key, num)`` as ``Keys`` in the key's mode: their words as a
    ``(num, 2)`` int32 tensor on the key's device, made in one launch."""
    key = _flat(key)
    num = int(num)
    return Keys(threefry(key.data, key.path, 0, num, "keys", total=0 if key.partitionable else num),
                key.partitionable)


def rows(keys: Keys, path: Tuple[int, ...], n: int, out=None) -> torch.Tensor:
    """``(J, n)``: row ``j`` is ``gumbel(Key(keys.data[j], path,
    keys.partitionable), (n,))``, all J rows in one launch: JAX's
    ``vmap(lambda k: gumbel(fold_in(k, t), (n,)))(keys)`` is ``rows(keys,
    (t,), n)``."""
    path = tuple(int(d) & _M32 for d in path)
    return threefry_rows(keys.data, path, n, out=out, original=not keys.partitionable)
"""The JAX package's key stream in the port: a twin of jax 0.9's threefry PRNG
(``jax._src.prng`` and ``jax._src.random``) in its partitionable mode, jax
0.9's default, so the same seed gives the port the same noise.

A key is two uint32 words, held as a ``(2,)`` int32 tensor on a device
(``Key``), so a runner carries and advances it on the device.  Everything is
the threefry2x32 hash of a counter under a key (``kernels.threefry``: a CUDA
kernel on the card, ``kernels.ref.threefry_ref`` on the CPU):

* ``PRNGKey(seed)`` is ``(0, seed mod 2**32)`` (``threefry_seed``, the seed
  taken as JAX's int32 of it);
* ``fold_in(key, d)`` hashes the counter ``(0, d)``, and in partitionable
  mode ``split(key, n)[i]`` hashes ``(0, i)``
  (``_threefry_split_foldlike``): the same key as ``fold_in(key, i)``, so a
  ``Key`` keeps its folds as a ``path`` and the kernel applies them once a
  block, where the key is used;
* ``random_bits(key, shape)`` hashes the flat index ``i`` as ``(i >> 32, i
  & 0xFFFFFFFF)`` into ``(a, b)`` and keeps ``a ^ b``
  (``_threefry_random_bits_partitionable``);
* ``uniform``, ``gumbel`` (mode ``"low"``), ``bernoulli``, ``exponential``
  and ``permutation`` (``_shuffle``: sorts by fresh 32-bit keys, stable)
  are ``jax.random``'s transforms of those bits.

Bits, keys, uniforms and permutations equal JAX's exactly; Gumbel and
exponential rows equal them up to the last bit of a ``log`` (ATen's and
XLA's differ by at most one ulp).  The non-partitionable mode (JAX's
``jax_threefry_partitionable=False``) is not ported: ``PRNGKey`` raises
``ValueError`` when asked for it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.threefry import MAX_PATH, threefry

__all__ = [
    "Key",
    "PRNGKey",
    "key_data",
    "fold_in",
    "split",
    "random_bits",
    "uniform",
    "gumbel",
    "bernoulli",
    "exponential",
    "permutation",
]

_M32 = 0xFFFFFFFF


class Key:
    """A JAX threefry key on a device: ``data``, a ``(2,)`` int32 tensor of
    its two uint32 words, folded by each integer of ``path`` in turn (not
    yet hashed).  ``key_data`` hashes the path in."""

    __slots__ = ("data", "path")

    def __init__(self, data: torch.Tensor, path: Tuple[int, ...] = ()):
        if data.dtype != torch.int32 or tuple(data.shape) != (2,):
            raise ValueError(f"a key's data is a (2,) int32 tensor, got {data.dtype} {tuple(data.shape)}")
        self.data, self.path = data, tuple(int(d) for d in path)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __repr__(self) -> str:
        return f"Key({self.data.tolist()}, path={self.path})"


def _words(seed: int) -> Tuple[int, int]:
    return 0, int(np.int64(seed).astype(np.int32)) & _M32


def PRNGKey(seed: int, device=None, partitionable: bool = True) -> Key:
    """JAX's ``PRNGKey(seed)`` on ``device`` (``None``: CUDA): the words
    ``(0, seed)``, the seed taken as JAX takes a Python int under 32-bit
    types (its low 32 bits)."""
    if not partitionable:
        raise ValueError("the non-partitionable threefry mode (jax_threefry_partitionable=False) is not ported")
    w = [v - 2**32 if v >= 2**31 else v for v in _words(seed)]
    return Key(torch.tensor(w, dtype=torch.int32, device=resolve_device(device)))


def key_data(key: Key) -> torch.Tensor:
    """The key's two words as a ``(2,)`` int32 tensor: its path hashed in
    (one launch), or its data as it is when the path is empty."""
    if not key.path:
        return key.data
    return threefry(key.data, key.path[:-1], key.path[-1], 1, "keys").view(2)


def _flat(key: Key) -> Key:
    """``key`` with a path the kernel takes in one launch."""
    return key if len(key.path) <= MAX_PATH else Key(key_data(Key(key.data, key.path[:MAX_PATH])),
                                                     key.path[MAX_PATH:])


def fold_in(key: Key, d: int) -> Key:
    """JAX's ``fold_in(key, d)`` (``d`` a host int, taken as uint32)."""
    return _flat(Key(key.data, key.path + (int(d) & _M32,)))


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """JAX's ``split(key, num)`` in partitionable mode: key ``i`` is
    ``fold_in(key, i)``."""
    return tuple(fold_in(key, i) for i in range(int(num)))


def _n(shape) -> Tuple[tuple, int]:
    shape = (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)
    return shape, math.prod(shape)


def _draw(key: Key, shape, mode: str, minval: float = 0.0, maxval: float = 1.0, out=None) -> torch.Tensor:
    shape, n = _n(shape)
    key = _flat(key)
    res = threefry(key.data, key.path, 0, n, mode, minval, maxval, out=None if out is None else out.view(-1))
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

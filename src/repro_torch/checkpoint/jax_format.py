"""The JAX package's checkpoint files, read by the port (``repro.checkpoint``'s
format), with the standard library, numpy and torch alone.

A JAX ``.ckpt`` file is one msgpack map: ``step``, ``treedef`` (a string),
``structure`` (the tree, packed again by msgpack, every leaf a ``0``),
``meta`` (each leaf's shape and dtype) and ``data``, the leaves' bytes end to
end, compressed by ``codec``: ``"zlib"`` (the standard library) or
``"zstd"`` (the optional ``zstandard`` package, imported only to read such
a file; without it the read raises ``ValueError`` naming the codec).  The
leaves lie in ``jax.tree.flatten``'s order: a dict's keys sorted, a list or
a NamedTuple (packed as a msgpack array) in order, ``None`` no leaf.

``read(path)`` returns ``(step, tree)``, the tree rebuilt from
``structure`` with numpy leaves: dicts by name, lists by position.  The
msgpack reader takes what the JAX writer emits: maps, arrays, strings,
binary, integers, floats, nil and booleans.
"""
from __future__ import annotations

import struct
import zlib
from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["is_jax_file", "read", "unpackb"]


def is_jax_file(blob: bytes) -> bool:
    """Whether ``blob`` starts as the JAX writer's file does: a msgpack map."""
    return bool(blob[:1]) and (0x80 <= blob[0] <= 0x8F or blob[0] in (0xDE, 0xDF))


class _Reader:
    def __init__(self, blob: bytes):
        self.blob, self.pos = blob, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.blob):
            raise ValueError("msgpack: the data ends inside a value")
        out = self.blob[self.pos: self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.uint(1 << (b - 0xC4)))
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            n = 1 << (b - 0xD0)
            return int.from_bytes(self.take(n), "big", signed=True)
        if b in (0xD9, 0xDA, 0xDB):
            return self.take(self.uint(1 << (b - 0xD9))).decode()
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.uint(2 if b == 0xDC else 4))]
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack: type byte 0x{b:02x} is not one the JAX checkpoint writer emits")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(blob: bytes) -> Any:
    """One msgpack value from ``blob`` (the subset above)."""
    r = _Reader(blob)
    out = r.value()
    if r.pos != len(blob):
        raise ValueError(f"msgpack: {len(blob) - r.pos} bytes after the value")
    return out


def _decompress(data: bytes, codec: str, path: str) -> bytes:
    if codec == "zlib":
        return zlib.decompress(data)
    if codec == "zstd":
        try:
            import zstandard
        except ImportError:
            raise ValueError(f"{path}: payload codec 'zstd' needs the zstandard package, which is not "
                             "installed; write the checkpoint with the zlib codec") from None
        return zstandard.ZstdDecompressor().decompress(data)
    raise ValueError(f"{path}: unknown payload codec {codec!r}")


def _leaf(raw: bytes, meta: dict):
    shape = tuple(meta["shape"])
    if meta["dtype"] == "bfloat16":  # the JAX writer stores bf16 as its 16-bit words
        bits = np.frombuffer(raw, np.uint16).reshape(shape)
        return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return np.frombuffer(raw, np.dtype(meta["dtype"])).reshape(shape).copy()


def _fill(node, leaves):
    if isinstance(node, dict):
        filled = {k: _fill(node[k], leaves) for k in sorted(node)}
        return {k: filled[k] for k in node}
    if isinstance(node, list):
        return [_fill(v, leaves) for v in node]
    if node is None:
        return None
    return next(leaves)


def read(path: str) -> Tuple[int, Any]:
    """``(step, tree)`` of a JAX checkpoint file (see the module docstring)."""
    with open(path, "rb") as f:
        blob = f.read()
    if not is_jax_file(blob):
        raise ValueError(f"{path} is not a JAX package checkpoint (not a msgpack map)")
    payload = unpackb(blob)
    missing = [k for k in ("step", "structure", "meta", "data") if k not in payload]
    if missing:
        raise ValueError(f"{path}: a JAX checkpoint without {missing}")
    raw = _decompress(payload["data"], payload.get("codec", "zstd"), path)
    leaves, off = [], 0
    for meta in payload["meta"]:
        n = int(np.prod(meta["shape"])) * (2 if meta["dtype"] == "bfloat16" else np.dtype(meta["dtype"]).itemsize)
        leaves.append(_leaf(raw[off: off + n], meta))
        off += n
    if off != len(raw):
        raise ValueError(f"{path}: the leaves take {off} bytes of a {len(raw)}-byte payload")
    it = iter(leaves)
    tree = _fill(unpackb(payload["structure"]), it)
    if next(it, None) is not None:
        raise ValueError(f"{path}: more leaves than the structure holds")
    return int(payload["step"]), tree

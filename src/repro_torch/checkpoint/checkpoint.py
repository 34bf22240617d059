"""Tree checkpoints in a format of the port's own (the counterpart of
``repro.checkpoint``), built from the stdlib and torch alone.

A ``.ckpt`` file is three parts:

* a magic line, ``REPRO_TORCH_CKPT 1\\n``;
* one line of JSON: the step, the tree's structure (``str`` of its
  ``torch.utils._pytree`` spec), each leaf's shape and dtype, the codec
  (``"raw"``) and the payload's size;
* the payload: every leaf's bytes in flattening order, stored as they are.

Trees are dicts, lists, tuples and NamedTuples of tensors.  ``restore(path,
like)`` puts each leaf on the device and dtype of the matching leaf of
``like``.  Nothing is pickled.  A file the JAX package wrote (msgpack) is
refused here: ``jax_format.read`` reads its trees, and
``repro_torch.serve.load_server`` loads a JAX serving stem onto the JAX key
stream.
"""
from __future__ import annotations

import json
import os
from typing import Any

import torch
from torch.utils import _pytree as pytree

from . import jax_format

__all__ = ["save", "restore", "latest_checkpoint", "read_header", "CODEC"]

MAGIC = b"REPRO_TORCH_CKPT 1\n"
# The payload codec, the one tag ``restore`` reads.  Raw, not zlib: on the
# sharded serving engine's arrays zlib level 1 wrote a young horizon's state
# in 1.4-2.1 times raw's time and a long-lived server's dense weights in
# 14-17 times, on the engine thread that stops serving while it writes
# (PERF.md section 5).
CODEC = "raw"

_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.int16, torch.int8,
    torch.uint8, torch.bool,
)}


def _leaf_bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()


def save(path: str, tree: Any, step: int = 0) -> str:
    """Write ``tree`` to ``path`` as a ``.tmp`` file, fsync it and rename it
    into place, so a crash mid-write never replaces a good checkpoint."""
    leaves, spec = pytree.tree_flatten(tree)
    for leaf in leaves:
        if not torch.is_tensor(leaf):
            raise TypeError(f"checkpoint leaves are tensors, got {type(leaf).__name__}")
        if str(leaf.dtype).removeprefix("torch.") not in _DTYPES:
            raise TypeError(f"checkpoint: unsupported dtype {leaf.dtype}")
    raw = b"".join(_leaf_bytes(t) for t in leaves)
    header = {
        "step": int(step),
        "structure": str(spec),
        "leaves": [{"shape": list(t.shape), "dtype": str(t.dtype).removeprefix("torch.")} for t in leaves],
        "codec": CODEC,
        "nbytes": len(raw),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(json.dumps(header, separators=(",", ":")).encode() + b"\n")
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def _read(path: str):
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(MAGIC):
        if jax_format.is_jax_file(blob):
            raise ValueError(f"{path} was written by the JAX package (msgpack): read it with "
                             "checkpoint.jax_format.read, or a serving stem with serve.load_server")
        raise ValueError(f"{path} is not a repro_torch checkpoint (bad magic line)")
    end = blob.index(b"\n", len(MAGIC))
    return json.loads(blob[len(MAGIC):end]), blob[end + 1:]


def read_header(path: str) -> dict:
    """The JSON header of a checkpoint (step, structure, leaves, codec)."""
    return _read(path)[0]


def restore(path: str, like: Any) -> Any:
    """The tree saved at ``path``, in the structure of ``like``: each leaf
    shaped as saved (it must equal the matching leaf's shape), on the device
    and in the dtype of the matching leaf of ``like``."""
    header, raw = _read(path)
    if header["codec"] != CODEC:
        raise ValueError(f"{path}: payload codec {header['codec']!r}; this reader takes {CODEC!r} only")
    if len(raw) != header["nbytes"]:
        raise ValueError(f"{path}: payload holds {len(raw)} bytes, header says {header['nbytes']}")
    like_leaves, spec = pytree.tree_flatten(like)
    if str(spec) != header["structure"] or len(like_leaves) != len(header["leaves"]):
        raise ValueError(f"{path}: saved structure {header['structure']} does not match {spec}")
    out, off = [], 0
    for leaf, meta in zip(like_leaves, header["leaves"]):
        shape, dtype = tuple(meta["shape"]), _DTYPES[meta["dtype"]]
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{path}: a leaf saved as {shape} where the like tree has {tuple(leaf.shape)}")
        n = dtype.itemsize * torch.Size(shape).numel()
        t = torch.frombuffer(bytearray(raw[off:off + n]), dtype=dtype).reshape(shape) if n else torch.empty(
            shape, dtype=dtype)
        off += n
        out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return pytree.tree_unflatten(out, spec)


def latest_checkpoint(directory: str, prefix: str = "ckpt_"):
    """The ``<prefix><step>.ckpt`` file of the highest step in ``directory``,
    or None."""
    if not os.path.isdir(directory):
        return None
    cands = [f for f in os.listdir(directory) if f.startswith(prefix) and f.endswith(".ckpt")]
    if not cands:
        return None
    best = max(cands, key=lambda f: int(f[len(prefix): -5]))
    return os.path.join(directory, best)

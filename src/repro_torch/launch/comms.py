"""Collective traffic of a program on a mesh, the port's counterpart of
``repro.launch.hlo`` (``collective_bytes``, ``count_ops``).

JAX reads the collectives out of the compiled HLO.  The port has no HLO:
DTensor issues each collective eagerly as a ``_c10d_functional`` operation
on a rank's local shards, so a dispatch mode that lets DTensor run first
(``metrics.ProgramCounter``: it returns ``NotImplemented`` for DTensor
arguments, as PyTorch's ``CommDebugMode`` does) sees every collective with
its local tensors and hands it to a ``CollectiveTally``.  Per
kind it sums the *result* bytes, as ``hlo.collective_bytes`` takes the
result shape: an all-gather counts the gathered bytes, a reduce-scatter the
scattered output, an all-reduce its buffer.  Under a ``"fake"`` process
group (the dry run, on ``meta`` tensors) the collectives move nothing and
their results have the right shapes, so the bytes are the plan's.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch
from torch.utils._pytree import tree_leaves

__all__ = ["KINDS", "collective_kind", "CollectiveTally", "count_ops"]

# the kinds of hlo.collective_bytes, by the name a functional collective has
KINDS = {
    "all_gather": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter": "reduce-scatter",
    "all_to_all": "all-to-all",
    "broadcast": "collective-permute",
}


def collective_kind(func) -> str | None:
    """The kind of a ``_c10d_functional`` (or its autograd twin's)
    collective, or None for any other operation (``wait_tensor`` too)."""
    ns = getattr(func, "namespace", "")
    if not ns.startswith("_c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1]
    return next((kind for key, kind in KINDS.items() if name.startswith(key)), None)


def _bytes(t) -> int:
    return t.numel() * t.element_size()


class CollectiveTally:
    """Result bytes and counts of collectives, per kind."""

    def __init__(self):
        self.bytes: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def add(self, kind: str, out) -> None:
        self.bytes[kind] += float(sum(_bytes(t) for t in tree_leaves(out) if isinstance(t, torch.Tensor)))
        self.counts[kind] += 1

    def summary(self) -> Dict[str, float]:
        """``{kind: bytes, "total": bytes, "n_<kind>": count}``, the keys of
        ``hlo.collective_bytes``."""
        out = dict(self.bytes)
        out["total"] = float(sum(self.bytes.values()))
        out.update({f"n_{k}": float(v) for k, v in self.counts.items()})
        return out


def count_ops(op_counts: Dict[str, int], names=("mm", "bmm", "index_put", "scatter", "copy_")) -> Dict[str, int]:
    """The counts of some operations by name (``hlo.count_ops``' counterpart:
    eager PyTorch has no fusions, custom calls or while loops, so it counts
    the matmuls, scatters and in-place writes a program launched)."""
    return {n: sum(c for op, c in op_counts.items() if op.split(".")[0] == n or op.startswith(n + "_"))
            for n in names}

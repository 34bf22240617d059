"""Capped sums of a bisection block: every candidate cap of ``b`` halvings
in one pass over the weights (the port of ``repro.kernels.bisect_tiles``).

The sort-free allocator (``repro_torch.engine.sharded``) with ``block=b``
probes the ``2**b - 1`` dyadic interior points of its bracket at once and
binary-searches the sums, so 48 sweeps of the weights become ``ceil(48/b)``.
``bisect_block_sums(w, caps)`` returns the ``(n_caps,)`` sums ``sum_j
min(w_j, caps_b)`` in ``w``'s dtype (float32 or float64).  Padding entries of
``w`` must be 0 and ``caps >= 0``.

On a CUDA tensor it launches ``csrc/bisect_block_sums.cu``; on a CPU tensor
it takes its plain version ``ref.bisect_block_sums_ref``.
"""
from __future__ import annotations

import torch

from ._build import check, launch, ptr, route
from .ref import bisect_block_sums_ref

__all__ = ["bisect_block_sums", "MAX_CAPS"]

MAX_CAPS = 63  # the most caps the kernel keeps in registers (block <= 6)
_DTYPES = (torch.float32, torch.float64)


def bisect_block_sums(w: torch.Tensor, caps: torch.Tensor, tile: int = 8192) -> torch.Tensor:
    """``(n_caps,)`` capped sums ``s_b = sum_j min(w_j, caps_b)``, summed per
    ``tile``-client tile and then across tiles."""
    if not route(w):
        return bisect_block_sums_ref(w, caps, tile=tile)
    if w.dtype not in _DTYPES:
        raise TypeError(f"bisect_block_sums takes float32 or float64 weights, got {w.dtype}")
    if caps.dim() != 1 or not 1 <= caps.shape[0] <= MAX_CAPS:
        raise ValueError(f"want 1 to {MAX_CAPS} caps in a 1-D tensor, got shape {tuple(caps.shape)}")
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    dev, K, n_caps = w.device, w.shape[0], caps.shape[0]
    caps = caps.to(w.dtype)
    check(w, "w", w.dtype, (K,), dev)
    check(caps, "caps", w.dtype, (n_caps,), dev)
    tile = min(tile, max(K, 1))
    partial = torch.empty(-(-K // tile) * n_caps, dtype=w.dtype, device=dev)
    out = torch.empty(n_caps, dtype=w.dtype, device=dev)
    vec = int(w.data_ptr() % 16 == 0 and tile * w.element_size() % 16 == 0)
    launch("repro_bisect_block_sums", dev, ptr(w), ptr(caps), ptr(partial), ptr(out), K, tile, n_caps,
           int(w.dtype == torch.float64), vec)
    bisect_block_sums.launches += 1
    return out


bisect_block_sums.launches = 0

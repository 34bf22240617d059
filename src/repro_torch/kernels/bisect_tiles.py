"""Capped sums of a bisection block: every candidate cap of ``b`` halvings
in one pass over the weights (the port of ``repro.kernels.bisect_tiles``).

The sort-free allocator (``repro_torch.engine.sharded``) with ``block=b``
probes the ``2**b - 1`` dyadic interior points of its bracket at once and
binary-searches the sums, so 48 sweeps of the weights become ``ceil(48/b)``.
``bisect_block_sums(w, caps)`` returns the ``(n_caps,)`` sums ``sum_j
min(w_j, caps_b)`` in ``w``'s dtype (float32 or float64).  Padding entries of
``w`` must be 0 and ``caps >= 0``.

On a CUDA tensor it launches ``csrc/bisect_block_sums.cu``, one kernel a
call: the last CTA to finish sums the tiles' partials, found by a ticket in a
slot of the library's static ticket array.  Eager calls on one (device,
stream) share a slot; each CUDA-graph capture takes a slot of its own, so
that graphs replayed at the same time, or a graph and eager calls, never
share one.  Eager calls that may run at the same time must come from
different streams.  The library keeps the slots: a capture's slot is held by
its graph and given back once the graph and its executable graphs are
destroyed, so a device has ``repro_bisect_ticket_slots()`` (65536) slots for
its streams and its live graphs, and any number of captures in turn.  On a
CPU tensor it takes its plain version ``ref.bisect_block_sums_ref``.
``tile=None`` looks the tile up in the autotune cache (``bisect_tiles``), as
the JAX package's ``bisect_block_sums`` does.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check, launch, load_library, ptr, route
from .autotune import best_config
from .ref import bisect_block_sums_ref

__all__ = ["bisect_block_sums", "MAX_CAPS"]

MAX_CAPS = 63  # the most caps the kernel keeps in registers (block <= 6)
_DTYPES = (torch.float32, torch.float64)


def _ticket_slot(dev: torch.device, stream: int) -> int:
    """The ticket slot of a launch on ``stream``: the stream's eager slot, or
    the slot of the graph capture in progress on it."""
    lib = load_library()
    slot = ctypes.c_int()
    with torch.cuda.device(dev):
        err = lib.repro_bisect_ticket_slot(stream, ctypes.byref(slot))
    if err == -1:
        raise RuntimeError(f"bisect_block_sums: all {lib.repro_bisect_ticket_slots()} ticket slots of {dev} are "
                           "taken (one per stream and one per live graph capture)")
    if err != 0:
        raise RuntimeError(f"bisect_block_sums: CUDA error {err} taking a ticket slot")
    return slot.value


def bisect_block_sums(w: torch.Tensor, caps: torch.Tensor, tile: int | None = None) -> torch.Tensor:
    """``(n_caps,)`` capped sums ``s_b = sum_j min(w_j, caps_b)``, summed per
    ``tile``-client tile and then across tiles in tile order: the same bits
    from call to call.  ``tile=None``: the autotune cache's tile for ``K``."""
    if tile is None:
        tile = int(best_config("bisect_tiles", w.shape[0], backend=w.device.type)["tile"])
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
    partial = torch.empty(max(-(-K // tile), 1) * n_caps, dtype=w.dtype, device=dev)
    out = torch.empty(n_caps, dtype=w.dtype, device=dev)
    vec = int(w.data_ptr() % 16 == 0 and tile * w.element_size() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch("repro_bisect_block_sums", dev, ptr(w), ptr(caps), ptr(partial), ptr(out), K, tile, n_caps,
           int(w.dtype == torch.float64), vec, _ticket_slot(dev, stream), stream=stream)
    bisect_block_sums.launches += 1
    return out


bisect_block_sums.launches = 0

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
stream) share a slot; each CUDA-graph capture takes a slot of its own for
each stream it captures on, so that graphs replayed at the same time, or a
graph and eager calls, never share one.  Eager calls that may run at the same
time must come from different streams.  On a CPU tensor it takes its plain
version ``ref.bisect_block_sums_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check, launch, load_library, ptr, route
from .ref import bisect_block_sums_ref

__all__ = ["bisect_block_sums", "MAX_CAPS"]

MAX_CAPS = 63  # the most caps the kernel keeps in registers (block <= 6)
_DTYPES = (torch.float32, torch.float64)
# (device index, stream handle, capture id or None) -> ticket slot, given at
# the key's first launch and kept
_slots: dict[tuple[int, int, int | None], int] = {}
_n_slots: dict[int, int] = {}  # device index -> slots given


def _ticket_slot(dev: torch.device, stream: int) -> int:
    """The ticket slot of a launch on ``stream``: one for the stream's eager
    calls, and one for each graph capture in progress on it."""
    lib = load_library()
    state = (ctypes.c_ulonglong * 2)()
    err = lib.repro_stream_capture_id(stream, state)
    if err != 0:
        raise RuntimeError(f"bisect_block_sums: CUDA error {err} querying the stream's capture")
    key = (dev.index, stream, state[1] if state[0] else None)
    slot = _slots.get(key)
    if slot is None:
        slot = _n_slots.get(dev.index, 0)
        if slot == lib.repro_bisect_ticket_slots():
            raise RuntimeError(f"bisect_block_sums: all {slot} ticket slots of {dev} are taken "
                               "(one per stream and one per graph capture)")
        _slots[key], _n_slots[dev.index] = slot, slot + 1
    return slot


def bisect_block_sums(w: torch.Tensor, caps: torch.Tensor, tile: int = 8192) -> torch.Tensor:
    """``(n_caps,)`` capped sums ``s_b = sum_j min(w_j, caps_b)``, summed per
    ``tile``-client tile and then across tiles in tile order: the same bits
    from call to call."""
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

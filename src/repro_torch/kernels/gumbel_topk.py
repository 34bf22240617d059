"""Exact top-k of given scores (the port of ``repro.kernels.gumbel_topk``).

``gumbel_topk_kernel_call(scores, k, tile)`` returns ``(vals, idx)``: the k
largest of the ``(K,)`` float32 scores and their int32 indices, in
``lax.top_k`` order (value descending, ties by index ascending).

Every top-k of the port (this one, the fused Gumbel top-k and the round's
select) runs the radix select of ``csrc/radix_topk.cuh``: ``N_PASSES``
passes of ``DIGIT_BITS``-bit digits (``N_BINS`` bins) over the 64-bit key
``(value bits, ~index)``, a candidate buffer of at most ``CAND_CAP`` keys,
a gather and a rank: ``LAUNCHES`` launches a call, whatever the data.  The
wrapper states these constants to the kernel, which refuses others, and
allocates the scratch (``radix_scratch``).  ``tile`` is the keys a CTA
takes per step of the row walks; the kernel is swept at ``TOPK_TILES``, and
a tile outside them, or ``k > MAX_K``, raises ``UnsupportedLaunch`` before
a launch.  The result does not depend on the tile.

On a CUDA tensor it launches ``csrc/gumbel_topk.cu``; on a CPU tensor it
takes its plain version ``ref.gumbel_topk_kernel_ref``, for any tile.
"""
from __future__ import annotations

import torch

from ._build import UnsupportedLaunch, check, launch, ptr, route
from .ref import gumbel_topk_kernel_ref

__all__ = [
    "gumbel_topk_kernel_call", "topk_launch", "radix_scratch", "TOPK_TILES", "MAX_K",
    "DIGIT_BITS", "N_BINS", "N_PASSES", "CAND_CAP", "LAUNCHES",
]

TOPK_TILES = (2048, 4096, 8192, 16384)  # the tiles the autotuner sweeps
MAX_K = 2048  # the rank step holds the k keys in shared memory (radix_topk.cuh kMaxK)
DIGIT_BITS = 11  # bits a pass resolves (kDigitBits)
N_BINS = 1 << DIGIT_BITS  # histogram bins a pass (kBins)
N_PASSES = -(-64 // DIGIT_BITS)  # passes for a 64-bit key: 6 (kPasses)
CAND_CAP = 1 << 16  # keys a candidate buffer holds at most
LAUNCHES = 1 + N_PASSES + 2  # the memset of state and histograms, the passes, the gather, the rank
_HEADER_WORDS = 16 + N_PASSES * N_BINS // 2  # int64 words of state and histograms (kHeaderWords)
_f32 = torch.float32


def topk_launch(tile: int, k: int) -> None:
    """Raise ``UnsupportedLaunch`` when the top-k kernels cannot take
    ``(tile, k)``."""
    if tile not in TOPK_TILES:
        raise UnsupportedLaunch(f"the top-k kernels are swept at tiles {TOPK_TILES}, got tile={tile}")
    if k > MAX_K:
        raise UnsupportedLaunch(f"the top-k kernels rank at most {MAX_K} keys, got k={k}")


def radix_scratch(K: int, k: int, device) -> tuple:
    """The radix select's scratch for a top-k of ``k`` of ``K`` keys and the
    arguments that state the engine to the kernel: ``(scratch, (DIGIT_BITS,
    N_BINS, N_PASSES, cap, scratch pointer))``.  The kernel zeroes what it
    relies on, on the stream."""
    cap = min(CAND_CAP, K)
    scratch = torch.empty(_HEADER_WORDS + k + 2 * cap, dtype=torch.int64, device=device)
    return scratch, (DIGIT_BITS, N_BINS, N_PASSES, cap, ptr(scratch))


def launch_topk(entry: str, rows, k: int, tile: int):
    """Launch a top-k entry over the ``(K,)`` float32 ``rows`` (name,
    tensor); returns ``(vals, idx)``."""
    dev, K = rows[0][1].device, rows[0][1].shape[0]
    if not 1 <= k <= K:
        raise ValueError(f"the top-k kernels take 1 <= k <= K; got k={k}, K={K}")
    if K >= 2**31:
        raise ValueError(f"the top-k kernels index clients with 32 bits; K={K} is too large")
    topk_launch(tile, k)
    for name, t in rows:
        check(t, name, _f32, (K,), dev)
    scratch, engine = radix_scratch(K, k, dev)
    vals = torch.empty(k, dtype=_f32, device=dev)
    idx = torch.empty(k, dtype=torch.int32, device=dev)
    launch(entry, dev, *(ptr(t) for _, t in rows), K, tile, k, *engine, ptr(vals), ptr(idx))
    return vals, idx


def gumbel_topk_kernel_call(scores: torch.Tensor, k: int, tile: int = 8192):
    """scores: (K,) perturbed log-probabilities.  Returns (values, indices)."""
    if not route(scores):
        return gumbel_topk_kernel_ref(scores, k)
    out = launch_topk("repro_gumbel_topk", (("scores", scores),), k, int(tile))
    gumbel_topk_kernel_call.launches += 1
    return out


gumbel_topk_kernel_call.launches = 0

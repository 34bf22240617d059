"""Exact top-k of given scores (the port of ``repro.kernels.gumbel_topk``).

``gumbel_topk_kernel_call(scores, k, tile)`` returns ``(vals, idx)``: the k
largest of the ``(K,)`` float32 scores and their int32 indices, in
``lax.top_k`` order (value descending, ties by index ascending).  ``tile``
is the first pass's chunk of ``csrc/block_topk.cuh``: one CTA sorts ``tile``
keys in shared memory.  The kernel is built for ``TOPK_TILES`` and needs
``2 * KP <= tile`` (``KP``, the next power of two ``>= k``, at most
``MAX_KP``); any other pair raises ``UnsupportedLaunch`` before a launch.
The result does not depend on the tile.

On a CUDA tensor it launches ``csrc/gumbel_topk.cu``; on a CPU tensor it
takes its plain version ``ref.gumbel_topk_kernel_ref``, for any tile.
"""
from __future__ import annotations

import torch

from ._build import UnsupportedLaunch, check, launch, ptr, route
from .ref import gumbel_topk_kernel_ref

__all__ = ["gumbel_topk_kernel_call", "topk_launch", "TOPK_TILES", "MAX_KP"]

TOPK_TILES = (2048, 4096, 8192, 16384)  # the chunks compiled; 32768 keys need 256 KB of shared memory
MAX_KP = 2048  # the longest candidate list (block_topk.cuh kMaxKP)
_f32 = torch.float32


def topk_launch(tile: int, k: int) -> int:
    """``KP`` for a top-k launch of ``k`` at ``tile``, or
    ``UnsupportedLaunch`` when the kernel cannot take the pair."""
    if tile not in TOPK_TILES:
        raise UnsupportedLaunch(f"the top-k kernels are built for tiles {TOPK_TILES}, got tile={tile}")
    KP = 1 << (k - 1).bit_length()
    if KP > MAX_KP or 2 * KP > tile:
        raise UnsupportedLaunch(
            f"k={k} needs candidate lists of {KP} keys: a tile must hold two of them "
            f"(2*{KP} <= tile={tile}) and KP <= {MAX_KP}"
        )
    return KP


def launch_topk(entry: str, rows, k: int, tile: int):
    """Launch a top-k entry over the ``(K,)`` float32 ``rows`` (name,
    tensor); returns ``(vals, idx)``."""
    dev, K = rows[0][1].device, rows[0][1].shape[0]
    if not 1 <= k <= K:
        raise ValueError(f"the top-k kernels take 1 <= k <= K; got k={k}, K={K}")
    if K >= 2**31:
        raise ValueError(f"the top-k kernels index clients with 32 bits; K={K} is too large")
    KP = topk_launch(tile, k)
    for name, t in rows:
        check(t, name, _f32, (K,), dev)
    n_chunks = -(-K // tile)
    cand_a = torch.empty(n_chunks * KP, dtype=torch.int64, device=dev)
    cand_b = torch.empty(-(-n_chunks // (tile // KP)) * KP, dtype=torch.int64, device=dev)
    vals = torch.empty(k, dtype=_f32, device=dev)
    idx = torch.empty(k, dtype=torch.int32, device=dev)
    launch(entry, dev, *(ptr(t) for _, t in rows), K, tile, ptr(cand_a), ptr(cand_b), KP, k, ptr(vals), ptr(idx))
    return vals, idx


def gumbel_topk_kernel_call(scores: torch.Tensor, k: int, tile: int = 8192):
    """scores: (K,) perturbed log-probabilities.  Returns (values, indices)."""
    if not route(scores):
        return gumbel_topk_kernel_ref(scores, k)
    out = launch_topk("repro_gumbel_topk", (("scores", scores),), k, int(tile))
    gumbel_topk_kernel_call.launches += 1
    return out


gumbel_topk_kernel_call.launches = 0

"""Packed outcome rows -> per-client rows (the staged round's replay path).

``unpack_bits``: ``(ceil(K/8),)`` uint8, little-endian, 8 clients a byte ->
``(K,)`` float32 0/1.  ``unpack_crumbs``: ``(ceil(K/4),)`` uint8, 4 clients a
byte -> ``(K,)`` int32 codes 0..3 (3 is the dead sentinel).  On a CUDA tensor
each launches its kernel (``csrc/unpack_bits.cu``); on a CPU tensor it
takes its plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from ._build import launch, ptr, route
from .ref import unpack_bits_ref, unpack_crumbs_ref

__all__ = ["unpack_bits", "unpack_crumbs"]


def _check_packed(packed: torch.Tensor, K: int, per_byte: int) -> None:
    need = -(-K // per_byte)
    if packed.dtype != torch.uint8 or packed.dim() != 1 or packed.shape[0] < need or not packed.is_contiguous():
        raise ValueError(
            f"want a contiguous 1-D uint8 row of at least {need} bytes for K={K}, "
            f"got {packed.dtype} {tuple(packed.shape)}"
        )


def unpack_bits(packed: torch.Tensor, K: int) -> torch.Tensor:
    """1-bit row -> ``(K,)`` float32 success bits."""
    if not route(packed):
        return unpack_bits_ref(packed, K)
    _check_packed(packed, K, 8)
    out = torch.empty(K, dtype=torch.float32, device=packed.device)
    launch("repro_unpack_bits", packed.device, ptr(packed), ptr(out), K)
    unpack_bits.launches += 1
    return out


def unpack_crumbs(packed: torch.Tensor, K: int) -> torch.Tensor:
    """2-bit row -> ``(K,)`` int32 codes in {0, 1, 2, 3}."""
    if not route(packed):
        return unpack_crumbs_ref(packed, K)
    _check_packed(packed, K, 4)
    out = torch.empty(K, dtype=torch.int32, device=packed.device)
    launch("repro_unpack_crumbs", packed.device, ptr(packed), ptr(out), K)
    unpack_crumbs.launches += 1
    return out


unpack_bits.launches = 0
unpack_crumbs.launches = 0

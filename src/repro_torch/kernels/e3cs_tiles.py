"""The E3CS hot-path kernels (the port of ``repro.kernels.e3cs_tiles``).

* ``fused_gumbel_topk_kernel_call(p, u, k, tile)`` perturbs ``log p`` with
  ``Gumbel(u) = -log(-log u)`` in registers, masks ``p <= 0`` and returns the
  top k ``(vals, idx)``; the perturbed scores never reach device memory
  (``csrc/gumbel_topk.cu``, the top-k launch rules of ``gumbel_topk.py``).
* ``e3cs_update_kernel_call(logw, p, sel_mask, x, frozen, scale, tile)`` is
  Eq. 16's estimator, Eq. 17's clamped step, the frozen mask and the
  log-weight add in one pass, with the max of each tile of ``tile`` clients
  (``csrc/e3cs_update.cu``).  Returns ``(new_logw, tmax)``; the caller
  re-centres with ``new_logw - tmax.max()``.

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
takes its plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from ._build import check, launch, ptr, route
from .gumbel_topk import launch_topk
from .ref import e3cs_update_kernel_ref, fused_gumbel_topk_kernel_ref, scalar_f32

__all__ = ["fused_gumbel_topk_kernel_call", "e3cs_update_kernel_call"]

_f32 = torch.float32


def fused_gumbel_topk_kernel_call(p: torch.Tensor, u: torch.Tensor, k: int, tile: int = 8192):
    """One-pass Plackett-Luce draw: ``p`` (K,) selection probabilities, ``u``
    (K,) iid Uniform(0, 1) variates.  Returns (values, indices): the top-k
    perturbed scores, descending."""
    if not route(p):
        return fused_gumbel_topk_kernel_ref(p, u, k)
    out = launch_topk("repro_fused_gumbel_topk", (("p", p), ("u", u)), k, int(tile))
    fused_gumbel_topk_kernel_call.launches += 1
    return out


def e3cs_update_kernel_call(logw, p, sel_mask, x, frozen, scale, tile: int = 8192):
    """Fused E3CS weight update (Eqs. 16-17) over (K,) float32 rows.

    ``scale`` is the exponent coefficient ``(k - K sigma) * eta / K`` (a
    number or a 0-d tensor); ``frozen`` may be boolean.  Returns
    ``(new_logw, tmax)`` with ``ceil(K / min(tile, max(K, 8)))`` tile maxes.
    """
    if not route(logw):
        return e3cs_update_kernel_ref(logw, p, sel_mask, x, frozen, scale, tile=tile)
    dev, K = logw.device, logw.shape[0]
    if K < 1 or tile < 1:
        raise ValueError(f"the update kernel takes K >= 1 and tile >= 1; got K={K}, tile={tile}")
    frozen = frozen.to(_f32)
    for name, t in (("logw", logw), ("p", p), ("sel_mask", sel_mask), ("x", x), ("frozen", frozen)):
        check(t, name, _f32, (K,), dev)
    tile = min(int(tile), max(K, 8))
    out = torch.empty(K, dtype=_f32, device=dev)
    tmax = torch.empty(-(-K // tile), dtype=_f32, device=dev)
    launch("repro_e3cs_update", dev, ptr(logw), ptr(p), ptr(sel_mask), ptr(x), ptr(frozen),
           ptr(scalar_f32(scale, dev)), K, tile, ptr(out), ptr(tmax))
    e3cs_update_kernel_call.launches += 1
    return out, tmax


fused_gumbel_topk_kernel_call.launches = 0
e3cs_update_kernel_call.launches = 0

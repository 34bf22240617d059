"""The kernel layer's public ops (the port of ``repro.kernels.ops``).

Where the JAX ops take a PRNG key and draw their noise inside, these take
the noise row as a tensor: the Gumbel row ``g`` (``sampling.gumbel_row``) or
the uniform row ``u`` (``sampling.uniform_row``), drawn by the caller from a
``torch.Generator`` on the device.  A test hands them JAX's own draws.

Launch tiles default to the autotune cache (``repro_torch.kernels.autotune``):
``tile=None`` looks up the tuned config for the ``(kernel, K-bucket,
float32, device type)`` at hand and falls back to the defaults on a cold
cache; both top-k ops share the ``gumbel_topk`` entry.  An explicit ``tile``
bypasses the cache.  Routing is by the tensors' device, as every wrapper of
the port routes: a CUDA tensor launches the kernel or raises, a CPU tensor
takes the plain version.
"""
from __future__ import annotations

import torch

from .autotune import best_config
from .e3cs_tiles import e3cs_update_kernel_call, fused_gumbel_topk_kernel_call
from .gumbel_topk import gumbel_topk_kernel_call

__all__ = ["gumbel_topk_sample", "fused_gumbel_topk_sample", "e3cs_update_tiled"]

_EPS = 1e-20


def _tile(kernel: str, t: torch.Tensor, tile) -> int:
    if tile is None:
        tile = best_config(kernel, t.shape[0], backend=t.device.type)["tile"]
    return int(tile)


def gumbel_topk_sample(g, p, k: int, tile: int = None):
    """Plackett-Luce k-subset sample over probabilities ``p`` (K,), perturbed
    by the Gumbel row ``g`` (K,).  Returns the (k,) int32 indices."""
    scores = torch.log(torch.clamp(p.to(torch.float32), min=_EPS)) + g
    _, idx = gumbel_topk_kernel_call(scores, k, tile=_tile("gumbel_topk", p, tile))
    return idx


def fused_gumbel_topk_sample(u, p, k: int, tile: int = None):
    """Single-pass Plackett-Luce sample from the uniform row ``u`` (K,): the
    Gumbel perturbation happens inside the kernel, so scores never
    round-trip through device memory."""
    _, idx = fused_gumbel_topk_kernel_call(p.to(torch.float32), u, k, tile=_tile("gumbel_topk", p, tile))
    return idx


def e3cs_update_tiled(logw, p, sel_mask, x, frozen, scale, tile: int = None):
    """Fused, re-centred E3CS weight update (Eqs. 16-17) at fleet scale."""
    new_logw, tmax = e3cs_update_kernel_call(
        logw, p, sel_mask, x, frozen, scale, tile=_tile("e3cs_tiles", logw, tile)
    )
    return new_logw - torch.max(tmax)

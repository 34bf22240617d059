"""Fused round kernels: the E3CS round's per-client work in two passes.

* **select** (``fused_alloc_select`` / ``fused_perturb_select``) rebuilds the
  allocation ``p`` from the four scalars of
  ``engine.sharded.masked_prob_alloc_scalars`` (or takes ``p`` as given),
  adds the Gumbel row and returns the exact top-k in ``lax.top_k`` order
  (``csrc/round_select.cu``, on the radix select of ``gumbel_topk.py``).
* **tail** (``fused_round_tail``) decodes the outcome row, applies Eq.
  16/17's clamped step, refreshes the loss cache and pops/shifts/pushes the
  credit and feedback rings (``csrc/round_tail.cu``).  The global
  re-centring max is reduced here from per-CTA maxes.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it takes its plain version in ``ref.py``.  On CUDA the tail updates the
``credit`` and ``fb`` rings IN PLACE and returns them; the plain version
returns new rings.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import check, launch, ptr, route
from .gumbel_topk import MAX_K, radix_scratch
from .ref import fused_alloc_select_ref, fused_perturb_select_ref, round_tail_ref, scalar_f32

__all__ = ["fused_alloc_select", "fused_perturb_select", "fused_round_tail", "MAX_K", "MAX_S"]

MAX_S = 4  # deepest staleness ring the tail kernel takes (kMaxS)
_TAIL_THREADS = 256
_KINDS = {"x": 0, "lag": 1, "bits": 2, "crumbs": 3}
_f32 = torch.float32


def _select(w, g, k: int, active, scal):
    """Launch ``repro_round_select``; ``scal`` None is from_p mode."""
    dev, K = w.device, w.shape[0]
    if not 1 <= k <= min(K, MAX_K):
        raise ValueError(f"the select kernel takes 1 <= k <= min(K, {MAX_K}); got k={k}, K={K}")
    if K >= 2**31:
        raise ValueError(f"the select kernel indexes clients with 32 bits; K={K} is too large")
    for name, t in (("w", w), ("g", g)) + ((("active", active),) if active is not None else ()):
        check(t, name, _f32, (K,), dev)
    scratch, engine = radix_scratch(K, k, dev)
    vals = torch.empty(k, dtype=_f32, device=dev)
    idx = torch.empty(k, dtype=torch.int32, device=dev)
    from_w = scal is not None
    p = torch.empty(K, dtype=_f32, device=dev) if from_w else None
    capped = torch.empty(K, dtype=torch.bool, device=dev) if from_w else None
    launch(
        "repro_round_select", dev, ptr(w), ptr(g), ptr(active), ptr(scal), K, int(from_w),
        ptr(p), ptr(capped), k, *engine, ptr(vals), ptr(idx),
    )
    return p, capped, vals, idx


def fused_alloc_select(w, g, k: int, *, sigma, scalars: Tuple, active: Optional[torch.Tensor] = None):
    """from_w select: ``(p, capped, vals, idx)`` from the masked weights
    ``w``, the Gumbel row ``g`` and ``scalars = (residual, cap, denom,
    use_cap)``."""
    if not route(w):
        return fused_alloc_select_ref(w, g, k, sigma=sigma, scalars=scalars, active=active)
    residual, cap, denom, use_cap = scalars
    scal = torch.stack([scalar_f32(v, w.device) for v in (sigma, residual, cap, denom, use_cap)])
    out = _select(w, g, k, active, scal)
    fused_alloc_select.launches += 1
    return out


def fused_perturb_select(p, g, k: int, *, active: Optional[torch.Tensor] = None):
    """from_p select (the sorted allocator's path): ``(vals, idx)``."""
    if not route(p):
        return fused_perturb_select_ref(p, g, k, active=active)
    _, _, vals, idx = _select(p, g, k, active, None)
    fused_perturb_select.launches += 1
    return vals, idx


def fused_round_tail(
    obs, mask, p, capped, logw, loss_cache, credit=None, fb=None, *,
    kind: str, residual, eta: float, K_glob: int, decay=(), active: Optional[torch.Tensor] = None,
):
    """The tail pass; see ``ref.round_tail_ref`` for the products.  ``m`` is
    the masked max of ``logw_pre`` that the caller re-centres by."""
    if not route(mask):
        return round_tail_ref(
            obs, mask, p, capped, logw, loss_cache, credit, fb,
            kind=kind, residual=residual, eta=eta, K_glob=K_glob, decay=decay, active=active,
        )
    if kind not in _KINDS:
        raise ValueError(f"unknown obs kind {kind!r}")
    dev, K = mask.device, mask.shape[0]
    is_async = kind in ("lag", "crumbs")
    S = len(decay) if credit is not None else 0
    late_fb = fb is not None
    if S > MAX_S:
        raise ValueError(f"the tail kernel takes staleness rings of at most {MAX_S} slots, got S={S}")
    if S > 0 and not is_async:
        raise ValueError(f"kind {kind!r} carries success bits, not lags: it has no credit ring")
    if late_fb and S == 0:
        raise ValueError("a feedback ring needs a credit ring (S > 0)")
    if kind in ("bits", "crumbs"):
        per_byte = 8 if kind == "bits" else 4
        check(obs, "obs", torch.uint8, (-(-K // per_byte),), dev)
    else:
        check(obs, "obs", _f32 if kind == "x" else torch.int32, (K,), dev)
    for name, t in (("mask", mask), ("p", p), ("logw", logw), ("loss_cache", loss_cache)):
        check(t, name, _f32, (K,), dev)
    check(capped, "capped", torch.bool, (K,), dev)
    if active is not None:
        check(active, "active", _f32, (K,), dev)
    if S > 0:
        check(credit, "credit", _f32, (S, K), dev)
    if late_fb:
        check(fb, "fb", _f32, (S, K), dev)

    def empty(dtype=_f32, n=K, on=True):
        return torch.empty(n, dtype=dtype, device=dev) if on else None

    x_out = empty(on=kind != "x")
    lag_out = empty(torch.int32, on=is_async)
    logw_out, loss_out = empty(), empty()
    arriving, arr_fb = empty(on=S > 0), empty(on=late_fb)
    block_max = empty(n=-(-K // _TAIL_THREADS))
    d = [float(v) for v in decay[:S]] + [0.0] * (MAX_S - S)
    launch(
        "repro_round_tail", dev, ptr(obs), _KINDS[kind], ptr(mask), ptr(p), ptr(capped), ptr(logw),
        ptr(loss_cache), ptr(active), ptr(credit if S > 0 else None), ptr(fb if late_fb else None),
        ptr(scalar_f32(residual, dev)), float(eta), float(K_glob), *d, S, int(late_fb),
        ptr(x_out), ptr(lag_out), ptr(logw_out), ptr(loss_out), ptr(arriving), ptr(arr_fb), ptr(block_max), K,
    )
    fused_round_tail.launches += 1
    out = {
        "x": obs if kind == "x" else x_out,
        "logw_pre": logw_out,
        "m": torch.max(block_max),
        "loss_cache": loss_out,
    }
    if is_async:
        out["lag"] = lag_out
    if S > 0:
        out["arriving"], out["credit"] = arriving, credit
    if late_fb:
        out["arr_fb"], out["fb"] = arr_fb, fb
    return out


fused_alloc_select.launches = 0
fused_perturb_select.launches = 0
fused_round_tail.launches = 0

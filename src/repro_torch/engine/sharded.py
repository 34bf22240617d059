"""Sort-free ProbAlloc and the K-sharded selection round (the port of
``repro.engine.sharded``).

The capped allocation solves ``g(alpha) = alpha / sum_j min(w_j, (1 -
sigma) alpha) = 1/(k - K sigma)`` (Eq. 24) by fixed-iteration bisection on
the monotone scalar ``g``; each step needs one ``sum_j min(w_j, cap)``.
Three levels of parallelism, all the same reduction, as in the JAX package:

* **tiles**: every sum is taken per 8192-client tile, then across tiles;
* **bracket blocks**: with ``block=b > 1`` each pass evaluates the capped sum
  at the ``2**b - 1`` dyadic interior points of the bracket in one sweep of
  the weights (``repro_torch.kernels.bisect_block_sums``, a CUDA kernel on
  the card) and binary-searches the sums: ``ceil(n_iters / b)`` sweeps
  instead of ``n_iters``;
* **ranks**: with ``mesh`` set, the weights are this rank's slab of a
  K-sharded population and every reduction ends in one collective of the
  mesh: a scalar ``psum`` per step, a ``(2**b - 1,)`` ``psum`` per block.

Both branches of the overflow test are computed and ``torch.where`` picks
one (JAX takes one under ``lax.cond``), and the next bracket is taken with
``index_select``, so the allocation never waits on the host.

SPMD placement.  JAX's ``shard_map`` wrappers take a global array and shard
it inside one process.  Here one process runs per rank (``repro_torch.
launch.mesh``): under ``mesh`` the allocator and ``_shard_topk_merge`` take
this rank's ``(Ks,)`` slab of a population zero-padded to ``K_pad = D * Ks``
(``active`` marks the padding) and return this rank's slab of per-client
outputs; scalars and cohort indices come back the same on every rank.  Where
JAX names an ``axis_name``, the port passes the ``HostMesh`` whose
collectives finish the reductions.
"""
from __future__ import annotations

import torch

from repro_torch.core.selection.prob_alloc import clip_sigma_one
from repro_torch.core.selection.sampling import local_topk_candidates, merge_topk_candidates
from repro_torch.kernels.bisect_tiles import bisect_block_sums

__all__ = ["masked_prob_alloc", "masked_prob_alloc_scalars", "N_ITERS", "TILE"]

N_ITERS = 48  # bisection halvings: the bracket shrinks to 2**-48 of its width
TILE = 8192  # clients per tile of the two-level sums


def _tiny(dt, device) -> torch.Tensor:
    """Dtype-scaled division guard (float32: ~1e-38)."""
    return torch.full((), torch.finfo(dt).tiny, dtype=dt, device=device)


def _pad_to_tile(x: torch.Tensor, tile: int) -> torch.Tensor:
    pad = (-x.shape[0]) % tile
    return torch.cat([x, x.new_zeros(pad)]) if pad else x


def _tiled_sum(x: torch.Tensor, tile: int) -> torch.Tensor:
    """Two-level (per-tile, then cross-tile) sum of an already tile-padded
    vector: the shape and accuracy of ``repro.engine.sharded._tiled_sum``."""
    return torch.sum(torch.sum(x.reshape(-1, tile), dim=1))


def _reduce_sum(x_padded: torch.Tensor, tile: int, mesh) -> torch.Tensor:
    s = _tiled_sum(x_padded, tile)
    return mesh.psum(s) if mesh is not None else s


def _alloc_prelude(w, k, sigma, active):
    """Cast to the weight dtype and fold the activity mask into the weights."""
    dt, dev = w.dtype, w.device
    active = torch.ones_like(w) if active is None else active.to(dt)
    return w * active, active, torch.as_tensor(k, dtype=dt, device=dev), torch.as_tensor(sigma, dtype=dt, device=dev)


def _alloc_scalars(w, k, sigma, active, *, n_iters: int, tile: int, mesh, block: int):
    """Bracket the cap by bisection; return ``(residual, cap, denom,
    use_cap)`` such that ``p_raw = sigma + residual * min(w, cap) / denom``,
    ``capped = (p_raw >= 1 - 1e-6) & use_cap`` and ``p = clip(p_raw, sigma,
    1) * active`` give the allocation."""
    if block < 1:
        raise ValueError(f"block must be at least 1, got {block}")
    dt, dev = w.dtype, w.device
    eps = _tiny(dt, dev)
    # zero padding is exact: min(0, cap) = 0 for every cap >= 0 the search tries
    w_t, a_t = _pad_to_tile(w, tile), _pad_to_tile(active, tile)
    K_act = _reduce_sum(a_t, tile, mesh)
    residual = k - K_act * sigma
    one_ms = 1.0 - sigma

    w_sum = _reduce_sum(w_t, tile, mesh)
    w_max = torch.max(torch.where(active > 0, w, torch.full_like(w, float("-inf"))))
    if mesh is not None:
        w_max = mesh.pmax(w_max)
    overflow = sigma + residual * w_max / torch.maximum(w_sum, eps) > 1.0 + 1e-9

    lo, hi = torch.zeros((), dtype=dt, device=dev), w_sum / torch.maximum(residual, eps)
    if block == 1:
        for _ in range(n_iters):
            mid = 0.5 * (lo + hi)
            s = _reduce_sum(torch.minimum(w_t, one_ms * mid), tile, mesh)
            go_up = mid * residual < s  # g(mid) < 1/residual: alpha too small
            lo, hi = torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)
    else:
        npts = (1 << block) - 1
        frac = torch.arange(1, npts + 1, dtype=dt, device=dev) / (npts + 1)  # a power of two: exact
        for _ in range(-(-n_iters // block)):
            mids = lo + (hi - lo) * frac  # the block's dyadic candidates
            s = bisect_block_sums(w, one_ms * mids, tile=tile)
            if mesh is not None:
                s = mesh.psum(s)
            n_up = torch.sum(mids * residual < s).reshape(1)
            grid = torch.cat([lo[None], mids, hi[None]])
            lo, hi = grid.index_select(0, n_up).reshape(()), grid.index_select(0, n_up + 1).reshape(())
    alpha = 0.5 * (lo + hi)
    cap_c = one_ms * alpha
    denom_c = torch.maximum(_reduce_sum(torch.minimum(w_t, cap_c), tile, mesh), eps)

    cap = torch.where(overflow, cap_c, torch.full((), float("inf"), dtype=dt, device=dev))
    denom = torch.where(overflow, denom_c, torch.maximum(w_sum, eps))
    return residual, cap, denom, overflow


def masked_prob_alloc(w, k, sigma, active=None, n_iters: int = N_ITERS, tile: int = TILE, mesh=None, block: int = 1):
    """Sort-free ProbAlloc (paper Algorithm 2) over an optionally masked
    population: ``(p, capped)`` with ``sum(p) = k``, ``sigma <= p_i <= 1`` on
    active arms and ``p_i = 0`` off them.  With ``mesh``, ``w`` and
    ``active`` are this rank's slab, ``k`` and ``sigma`` stay global, and the
    result is this rank's slab."""
    w, active, k, sigma = _alloc_prelude(w, k, sigma, active)
    residual, cap, denom, use_cap = _alloc_scalars(
        w, k, sigma, active, n_iters=n_iters, tile=tile, mesh=mesh, block=block
    )
    p = sigma + residual * torch.minimum(w, cap) / denom
    capped = (p >= 1.0 - 1e-6) & use_cap
    p = clip_sigma_one(p, sigma) * active
    return p, capped & (active > 0)


def masked_prob_alloc_scalars(w, k, sigma, active=None, n_iters: int = N_ITERS, tile: int = TILE, mesh=None,
                              block: int = 1):
    """``masked_prob_alloc`` minus its elementwise epilogue: ``(residual,
    cap, denom, use_cap)`` for the fused select kernel."""
    w, active, k, sigma = _alloc_prelude(w, k, sigma, active)
    return _alloc_scalars(w, k, sigma, active, n_iters=n_iters, tile=tile, mesh=mesh, block=block)


def _shard_topk_merge(scores_loc: torch.Tensor, k: int, mesh) -> torch.Tensor:
    """The distributed top-k of a K-sharded score vector (this rank's slab,
    padded with ``-inf``) without gathering it: this rank's ``top_k``
    candidates with global indices (offset ``rank * Ks``), an all-gather of
    the ``(D, k)`` pairs and the exact merge.  Returns the ``(k,)`` global
    indices, the same on every rank: exactly ``top_k`` of the whole vector,
    ties included (``merge_topk_candidates``)."""
    Ks = scores_loc.shape[0]
    if k > Ks:
        raise ValueError(f"k={k} exceeds the shard width {Ks}; need k <= K_pad/D")
    v, gi = local_topk_candidates(scores_loc, k, mesh.rank * Ks)
    return merge_topk_candidates(mesh.all_gather(v), mesh.all_gather(gi), k)

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

Rows.  ``masked_prob_alloc`` also takes ``(J, K)`` weights and masks with a
``(J,)`` ``k`` and ``sigma``, one allocation a row (the multi-job engine,
``block=1`` and no mesh, as JAX vmaps it).  Each row's sums are taken as
the 1-D call takes them, one row at a time: PyTorch's CUDA reduction picks
its order from the number of outputs it makes, so a ``(J, n_tiles, tile)``
sum could round a row otherwise than the row's own ``(n_tiles, tile)`` sum,
and a job's allocation would depend on the batch it rides in.  Everything
else is elementwise or an exact max over the rows at once.

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
from repro_torch.core.selection.sampling import local_topk_candidates, merge_topk_candidates, perturbed_scores
from repro_torch.kernels.bisect_tiles import bisect_block_sums

__all__ = [
    "prob_alloc_sharded",
    "masked_prob_alloc",
    "masked_prob_alloc_scalars",
    "prob_alloc_shmap",
    "distributed_topk",
    "plackett_luce_shmap",
    "build_sharded_scan_runner",
    "sharded_selection_sim",
    "N_ITERS",
    "TILE",
]

N_ITERS = 48  # bisection halvings: the bracket shrinks to 2**-48 of its width
TILE = 8192  # clients per tile of the two-level sums


def _tiny(dt, device) -> torch.Tensor:
    """Dtype-scaled division guard (float32: ~1e-38)."""
    return torch.full((), torch.finfo(dt).tiny, dtype=dt, device=device)


def _pad_to_tile(x: torch.Tensor, tile: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % tile
    return torch.cat([x, x.new_zeros(*x.shape[:-1], pad)], dim=-1) if pad else x


def _tiled_sum(x: torch.Tensor, tile: int) -> torch.Tensor:
    """Two-level (per-tile, then cross-tile) sum of an already tile-padded
    vector: the shape and accuracy of ``repro.engine.sharded._tiled_sum``.
    Rows give a ``(J, 1)`` column, each row summed as a vector is."""
    if x.dim() > 1:
        rows = x.reshape(-1, x.shape[-1])
        return torch.stack([_tiled_sum(r, tile) for r in rows]).reshape(*x.shape[:-1], 1)
    return torch.sum(torch.sum(x.reshape(-1, tile), dim=1))


def _row_max(x: torch.Tensor) -> torch.Tensor:
    """The max of a vector, or each row's as a ``(J, 1)`` column."""
    return torch.max(x) if x.dim() == 1 else torch.amax(x, dim=-1, keepdim=True)


def _reduce_sum(x_padded: torch.Tensor, tile: int, mesh) -> torch.Tensor:
    s = _tiled_sum(x_padded, tile)
    return mesh.psum(s) if mesh is not None else s


def _scalar(v, dt, device) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``dt`` on ``device``: a tensor is cast on the
    device, a Python number is filled in by a kernel (no copy from host
    memory, which a CUDA graph cannot capture)."""
    if torch.is_tensor(v):
        return v.to(dtype=dt, device=device)
    return torch.full((), v, dtype=dt, device=device)


def _alloc_prelude(w, k, sigma, active):
    """Cast to the weight dtype and fold the activity mask into the weights;
    over rows, a ``(J,)`` ``k`` and ``sigma`` become ``(J, 1)`` columns."""
    dt, dev = w.dtype, w.device
    active = torch.ones_like(w) if active is None else active.to(dt)
    k, sigma = _scalar(k, dt, dev), _scalar(sigma, dt, dev)
    if w.dim() > 1:
        k, sigma = (v.reshape(*v.shape, 1) if v.dim() else v for v in (k, sigma))
    return w * active, active, k, sigma


def _alloc_scalars(w, k, sigma, active, *, n_iters: int, tile: int, mesh, block: int):
    """Bracket the cap by bisection; return ``(residual, cap, denom,
    use_cap)`` such that ``p_raw = sigma + residual * min(w, cap) / denom``,
    ``capped = (p_raw >= 1 - 1e-6) & use_cap`` and ``p = clip(p_raw, sigma,
    1) * active`` give the allocation."""
    if block < 1:
        raise ValueError(f"block must be at least 1, got {block}")
    if w.dim() > 1 and (block > 1 or mesh is not None):
        raise ValueError("an allocation over rows runs at block=1 on one device")
    dt, dev = w.dtype, w.device
    eps = _tiny(dt, dev)
    # zero padding is exact: min(0, cap) = 0 for every cap >= 0 the search tries
    w_t, a_t = _pad_to_tile(w, tile), _pad_to_tile(active, tile)
    K_act = _reduce_sum(a_t, tile, mesh)
    residual = k - K_act * sigma
    one_ms = 1.0 - sigma

    w_sum = _reduce_sum(w_t, tile, mesh)
    w_max = _row_max(torch.where(active > 0, w, torch.full_like(w, float("-inf"))))
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
    result is this rank's slab.  ``(J, K)`` rows with a ``(J,)`` ``k`` and
    ``sigma`` allocate each row (``block=1``, no mesh)."""
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


def prob_alloc_sharded(w, k, sigma, n_iters: int = N_ITERS, tile: int = TILE, block: int = 1):
    """The drop-in for ``core.selection.prob_alloc`` at fleet scale: the same
    ``(p, capped)`` contract with no sort (``masked_prob_alloc`` over every
    client)."""
    return masked_prob_alloc(w, k, sigma, active=None, n_iters=n_iters, tile=tile, block=block)


def _pad_slab(x: torch.Tensor, mesh, fill: float = 0.0) -> torch.Tensor:
    """This rank's slab of a global ``(K,)`` row padded with ``fill`` to
    ``K_pad = D * ceil(K / D)``."""
    K, D = x.shape[0], mesh.size
    Ks = -(-K // D)
    if D * Ks != K:
        x = torch.cat([x, x.new_full((D * Ks - K,), fill)])
    return x[mesh.rank * Ks:(mesh.rank + 1) * Ks].contiguous()


def prob_alloc_shmap(w, k, sigma, mesh, active=None, n_iters: int = N_ITERS, tile: int = TILE, block: int = 1):
    """``masked_prob_alloc`` over the ranks of ``mesh``: every rank passes the
    global ``(K,)`` weights (and mask), allocates its slab of them with one
    collective per bisection step (or block), and returns the global ``(p,
    capped)`` gathered from the ranks and cut to K, the same on every rank."""
    K = w.shape[0]
    active = torch.ones_like(w) if active is None else active.to(w.dtype)
    p, capped = masked_prob_alloc(_pad_slab(w, mesh), k, sigma, active=_pad_slab(active, mesh), n_iters=n_iters,
                                  tile=tile, mesh=mesh, block=block)
    return _gather_rows(p, mesh, K), _gather_rows(capped.to(w.dtype), mesh, K) > 0


def distributed_topk(scores: torch.Tensor, k: int, mesh) -> torch.Tensor:
    """The global top-k indices of a ``(K,)`` score row that every rank
    holds, each rank ranking only its slab: exactly ``top_k(scores, k)``,
    ties included, the same ``(k,)`` int32 indices on every rank."""
    Ks = -(-scores.shape[0] // mesh.size)
    if k > Ks:
        raise ValueError(f"k={k} exceeds the shard width {Ks} (= ceil(K/D)); need k <= K/D")
    return _shard_topk_merge(_pad_slab(scores, mesh, float("-inf")), k, mesh)


def plackett_luce_shmap(g_loc: torch.Tensor, p: torch.Tensor, k: int, mesh) -> torch.Tensor:
    """A K-sharded Plackett-Luce draw: this rank perturbs its slab of ``log
    p`` (``p`` global, ``(K,)``) with its ``(Ks,)`` Gumbel slab ``g_loc``
    (JAX draws it from ``fold_in(key, rank)`` when D > 1) and the cohort is
    the distributed top-k of the perturbed scores: ``(k,)`` global indices,
    the same on every rank."""
    K = p.shape[0]
    Ks = -(-K // mesh.size)
    if k > Ks:
        raise ValueError(f"k={k} exceeds the shard width {Ks} (= ceil(K/D)); need k <= K/D")
    pos = torch.arange(mesh.rank * Ks, (mesh.rank + 1) * Ks, device=p.device)
    scores = perturbed_scores(g_loc, _pad_slab(p, mesh))
    return _shard_topk_merge(torch.where(pos < K, scores, torch.full_like(scores, float("-inf"))), k, mesh)


def build_sharded_scan_runner(fl, vol, rho, mesh, override: str = "none", outputs: str = "full", block: int = 1,
                              staleness=None, alpha: float = 0.5, feedback: str = "deadline", carry_key: bool = False,
                              scan_length=None, taps: bool = False, fused: bool = False, device=None):
    """The K-sharded round over a whole horizon on this rank of ``mesh``:
    ``RoundProgram(mesh=mesh, ...).build_runner(...)``, with its contracts
    (every per-client array this rank's slab).  The bisection's halvings and
    tile are the constants ``N_ITERS`` and ``TILE``."""
    from repro_torch.engine.round_program import RoundProgram  # the round program imports this module

    program = RoundProgram(fl=fl, vol=vol, rho=rho, override=override, staleness=staleness, alpha=alpha,
                           feedback=feedback, mesh=mesh, block=block, fused=fused, device=device)
    return program.build_runner(outputs=outputs, carry_key=carry_key, scan_length=scan_length, taps=taps)


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


def _gather_rows(x: torch.Tensor, mesh, K: int) -> torch.Tensor:
    """The ranks' ``(T, Ks)`` slabs side by side, cut to the ``K`` clients."""
    parts = mesh.all_gather(x).reshape(mesh.size, *x.shape)
    return torch.cat(list(parts), dim=-1)[..., :K]


def sharded_selection_sim(
    scheme: str,
    mesh,
    K: int = 100,
    k: int = 20,
    T: int = 2500,
    quota: str = "const",
    frac: float = 0.0,
    eta: float = 0.5,
    volatility: str = "bernoulli",
    stickiness: float = 0.8,
    seed: int = 0,
    xs_override=None,
    packed_override=None,
    outputs: str = "full",
    block: int = 1,
    vol=None,
    rho=None,
    taps: bool = False,
    fused: bool = False,
    device=None,
):
    """The K-sharded counterpart of ``scan_sim.scan_selection_sim`` on this
    process's rank of ``mesh`` (``repro_torch.launch.mesh``): every scheme,
    over a model with K-indexed fields (or a replayed trace), ``block``
    halvings a sweep through the block-sum kernel.  Returns the same numpy
    dict on every rank, per-client arrays gathered from the ranks and cut
    to the K clients; ``taps=True`` adds ``"taps"``."""
    import numpy as np

    from repro_torch.configs.base import FLConfig
    from repro_torch.core.volatility import make_volatility, paper_success_rates
    from repro_torch.core.prng import PRNGKey
    from repro_torch.engine.round_program import RoundProgram

    if xs_override is not None and packed_override is not None:
        raise ValueError("pass at most one of xs_override / packed_override")
    override = "dense" if xs_override is not None else ("packed" if packed_override is not None else "none")
    fl = FLConfig(K=K, k=k, rounds=T, scheme=scheme, quota=quota, quota_frac=frac, eta=eta, allocator="bisect")
    if rho is None:
        rho = getattr(vol, "rho", None)
    if rho is None:
        rho = paper_success_rates(K)
    if vol is None:
        dev = mesh.device if device is None else device
        vol = make_volatility(volatility, rho, stickiness=stickiness, seed=seed, device=dev)
    program = RoundProgram(fl=fl, vol=vol, rho=rho, override=override, mesh=mesh, block=block, fused=fused,
                           device=device)
    run, state = program.build_runner(outputs=outputs, taps=taps)
    xs = None
    if override != "none":
        trace = xs_override if override == "dense" else packed_override
        xs = program.local_rows(np.asarray(trace, np.float32 if override == "dense" else np.uint8))
    state, *outs = run(state, PRNGKey(seed, program.device), xs)

    def host(t):
        return t.detach().cpu().numpy()

    if taps:
        *outs, payload = outs
    if outputs == "lean":
        successes, sigmas = outs
        out = {"successes": host(successes), "sigmas": host(sigmas),
               "counts": host(_gather_rows(state.sel_counts, mesh, K))}
    else:
        masks, xs_out, ps, sigmas = outs
        masks = host(_gather_rows(masks, mesh, K))
        out = {"masks": masks, "xs": host(_gather_rows(xs_out, mesh, K)), "ps": host(_gather_rows(ps, mesh, K)),
               "sigmas": host(sigmas), "counts": masks.sum(0)}
    if taps:
        out["taps"] = {"series": {n: host(v) for n, v in payload["series"].items()},
                       "counters": {n: float(v) for n, v in payload["counters"].items()}}
    return out

"""Batched multi-tenant selection engine: J concurrent FL jobs a dispatch
(the port of ``repro.engine.multi_job``).

A selection service runs many federated populations at once (products,
regions, cohort sizes), each needing a fraction of a millisecond of device
time a round.  One E3CS selection and update step runs over a ``(J,
K_max)``-packed state, so a single device step serves every job of the
batch a tick.

Heterogeneity (K_j, k_j, sigma_j, eta_j) is handled with padding masks:

* populations are padded to ``K_max``; ``active`` masks dead slots out of
  the allocator, the sampler and the weight update;
* cohorts are padded to ``k_max``; selection indices beyond ``k_j`` are
  returned as ``-1`` and contribute nothing to the update.

``job_step`` on a padded row is the definition of the single-job engine,
and ``batched_step`` runs the same operations over the rows: the allocator
is ``engine.sharded.masked_prob_alloc`` over rows (each row's sums taken as
the row's own), the top-k is ``sampling.exact_top_k`` (the exact top-k
kernel a row where ``k_max`` fits it, a stable sort above), so the batched
step's cohorts equal J independent ``job_step`` calls given the same Gumbel
rows.  The noise is fed as tensors: a ``(K_max,)`` Gumbel row a job, or the
``(J, K_max)`` rows of the batch.  The JAX package's batched step draws job
``j``'s row as ``gumbel(key_j, (K_max,))``; the port's drivers draw all J
rows in one launch, ``core.prng.rows(keys, (t,), K_max)`` (the ``(J, 2)``
words of the jobs' base keys folded by the round ``t``).
``job_generator`` is the port's Philox stream for a job, kept for callers
that ask for it.

On a CUDA device ``batched_step`` replays one CUDA graph per ``(J, K_max,
k_max)`` over static buffers (the counterpart of ``jax.jit``): its first
call with a shape warms the step up on a side stream and captures it; every
call copies its arguments into the buffers, replays, and returns copies of
the outputs.  Configs are data: ``slot_admit`` / ``slot_retire`` return new
configs, which the next call copies in, so a captured step serves them
without a new capture.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.selection.sampling import exact_top_k
from repro_torch.device import resolve_device
from repro_torch.kernels import add_launch_counts

from .round_program import capture_step
from .sharded import N_ITERS, TILE, _row_max, masked_prob_alloc

__all__ = [
    "MultiJobConfig",
    "MultiJobState",
    "pack_jobs",
    "multi_job_init",
    "make_multi_job",
    "slot_admit",
    "slot_retire",
    "pad_slots",
    "job_generator",
    "plain_batched_step",
]

_EPS = 1e-20
_f32 = torch.float32


class MultiJobConfig(NamedTuple):
    """Per-job parameters, packed to ``(J,)`` / ``(J, K_max)`` tensors."""

    k: torch.Tensor  # (J,) int32 cohort sizes, <= k_max
    sigma: torch.Tensor  # (J,) float32 absolute fairness floors
    eta: torch.Tensor  # (J,) float32 learning rates
    active: torch.Tensor  # (J, K_max) {0,1} client-validity masks


class MultiJobState(NamedTuple):
    """Evolving per-job selector state, packed along the ``J`` axis."""

    logw: torch.Tensor  # (J, K_max) E3CS log-weights
    t: torch.Tensor  # (J,) int32 round counters


def pack_jobs(
    Ks: Sequence[int],
    ks: Sequence[int],
    sigma_fracs: Sequence[float],
    etas: Sequence[float],
    K_max: int | None = None,
    device=None,
) -> Tuple[MultiJobConfig, int]:
    """Pad J heterogeneous jobs into one batch on ``device`` (``None``:
    CUDA); returns ``(config, k_max)``.  ``sigma_fracs`` are fairness floors
    as fractions of each job's uniform rate ``k/K``."""
    dev = resolve_device(device)
    Ks, ks = list(Ks), list(ks)
    K_max = K_max or max(Ks)
    k_max = max(ks)
    active = np.zeros((len(Ks), K_max), np.float32)
    for j, Kj in enumerate(Ks):
        active[j, :Kj] = 1.0
    sigma = np.asarray([f * kj / Kj for f, kj, Kj in zip(sigma_fracs, ks, Ks)], np.float32)
    cfg = MultiJobConfig(
        k=torch.as_tensor(np.asarray(ks, np.int32), device=dev),
        sigma=torch.as_tensor(sigma, device=dev),
        eta=torch.as_tensor(np.asarray(etas, np.float32), device=dev),
        active=torch.as_tensor(active, device=dev),
    )
    return cfg, k_max


def multi_job_init(cfg: MultiJobConfig) -> MultiJobState:
    """Fresh state for a packed batch: uniform weights, round counters at 0."""
    J, K_max = cfg.active.shape
    dev = cfg.active.device
    return MultiJobState(logw=torch.zeros((J, K_max), dtype=_f32, device=dev),
                         t=torch.zeros((J,), dtype=torch.int32, device=dev))


def slot_admit(cfg: MultiJobConfig, slot: int, K: int, k: int, sigma_frac: float, eta: float) -> MultiJobConfig:
    """A new config with one slot claimed for a new tenant job: the first
    ``K`` entries of the slot's ``active`` row go live, the rest stay dead
    padding, and ``(k, sigma, eta)`` take the job's values (``sigma_frac``
    of the job's uniform rate ``k/K``).  Shapes do not change, so a captured
    step serves the new config."""
    K_max = cfg.active.shape[1]
    if not (0 < K <= K_max):
        raise ValueError(f"job population K={K} must be in (0, {K_max}]")
    if not (0 < k <= K):
        raise ValueError(f"cohort size k={k} must be in (0, K={K}]")
    new = MultiJobConfig(*(v.clone() for v in cfg))
    new.k[slot] = k
    new.sigma[slot] = sigma_frac * k / K
    new.eta[slot] = eta
    new.active[slot] = (torch.arange(K_max, device=cfg.active.device) < K).to(_f32)
    return new


def slot_retire(cfg: MultiJobConfig, slot: int) -> MultiJobConfig:
    """A new config with one slot released: its ``active`` row goes fully
    dead, ready for the next ``slot_admit``."""
    active = cfg.active.clone()
    active[slot] = 0.0
    return cfg._replace(active=active)


def pad_slots(cfg: MultiJobConfig, state: MultiJobState, new_J: int):
    """Grow a packed batch to ``new_J`` slots; returns ``(cfg, state)``.  The
    new slots are dead padding (``active == 0``, ``k = 1``); live rows are
    copied unchanged, so a job's selections do not change with the growth.
    A captured ``batched_step`` captures once more for each new ``J``."""
    J = cfg.active.shape[0]
    if new_J < J:
        raise ValueError(f"cannot shrink a batch in place: {J} -> {new_J} slots")
    if new_J == J:
        return cfg, state
    pad = new_J - J

    def grow(a, fill=0):
        return torch.cat([a, a.new_full((pad, *a.shape[1:]), fill)])

    cfg = MultiJobConfig(k=grow(cfg.k, 1), sigma=grow(cfg.sigma), eta=grow(cfg.eta), active=grow(cfg.active))
    return cfg, MultiJobState(logw=grow(state.logw), t=grow(state.t))


def job_generator(seed: int, j: int, device) -> torch.Generator:
    """Job ``j``'s noise stream: a generator on ``device`` seeded from
    ``SeedSequence([seed, j])``, so a job's draws do not depend on how many
    jobs run beside it (JAX folds the round into ``split(key, J)[j]``)."""
    state = np.random.SeedSequence([int(seed), int(j)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _col(v: torch.Tensor) -> torch.Tensor:
    """A job's scalar against its row of clients: a ``(J,)`` vector as a
    ``(J, 1)`` column, a 0-d scalar as ``(1,)``."""
    return v[..., None]


def _step(cfg: MultiJobConfig, logw, t, g, x, k_max: int, n_iters: int, tile: int):
    """One E3CS step of one job (``cfg`` a row: 0-d ``k``, ``sigma``,
    ``eta``; ``(K_max,)`` rows) or of a batch (``(J,)`` and ``(J, K_max)``):
    the same operations either way."""
    active = cfg.active
    kf = cfg.k.to(_f32)
    K_act = torch.sum(active, dim=-1)  # a count of 0/1 entries: exact in any order
    neg_inf = torch.full((), float("-inf"), dtype=logw.dtype, device=logw.device)

    # ProbAlloc over the live slots (Algorithm 2, sort-free)
    w = torch.exp(logw - _row_max(torch.where(active > 0, logw, neg_inf)))
    p, capped = masked_prob_alloc(w, kf, cfg.sigma, active=active, n_iters=n_iters, tile=tile)

    # Plackett-Luce draw: Gumbel top-k over the padded row; slots beyond k_j
    # are reported as -1 and dropped from the mask
    scores = torch.where(active > 0, torch.log(torch.clamp(p, min=_EPS)) + g, neg_inf)
    _, idx = exact_top_k(scores, k_max)
    valid = torch.arange(k_max, dtype=torch.int32, device=idx.device) < _col(cfg.k)
    mask = torch.zeros_like(p).scatter_reduce_(-1, idx.long(), valid.to(p.dtype), reduce="amax")
    idx = torch.where(valid, idx, torch.full_like(idx, -1))

    # E3CS exponential-weight update (Eqs. 16-17) with the job's (k, sigma)
    xhat = mask * x / torch.clamp(p, min=1e-12)
    residual = kf - K_act * cfg.sigma
    step = torch.clamp(_col(residual) * _col(cfg.eta) * xhat / _col(torch.clamp(K_act, min=1.0)), max=1.0)
    new_logw = logw + torch.where(capped | (active == 0), torch.zeros_like(step), step)
    new_logw = new_logw - _row_max(torch.where(active > 0, new_logw, neg_inf))
    new_logw = new_logw * active  # dead slots stay pinned at 0
    return new_logw, t + 1, {"idx": idx, "mask": mask, "p": p, "capped": capped}


def plain_batched_step(cfg: MultiJobConfig, state: MultiJobState, gs, xs, *, k_max: int, n_iters: int = N_ITERS,
                       tile: int = TILE):
    """``batched_step``'s operations, uncaptured: every job of the batch at
    once on ``gs``, the ``(J, K_max)`` Gumbel rows.  A caller that captures
    a larger step around it (the service's tick) calls this one."""
    logw, t, out = _step(cfg, state.logw, state.t, gs, xs, k_max, n_iters, tile)
    return MultiJobState(logw=logw, t=t), out


class _Captured:
    """``fn(*args)`` on a CUDA device as one CUDA graph per argument shape:
    its first call with a shape copies the arguments into static buffers,
    warms ``fn`` up on a side stream and captures it; every call copies its
    arguments in, replays, and returns copies of the outputs.  The kernel
    launches of a replay are counted at each replay (taken back after the
    capture, as ``RoundProgram``'s runner does)."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs = {}  # (spec, shapes and dtypes) -> (static inputs, graph, outputs, launches a replay)

    def _capture(self, key, leaves, spec, dev):
        static = [v.detach().clone() for v in leaves]

        def body():
            return self.fn(*pytree.tree_unflatten(static, spec))

        graph, outs, per_replay, _, _ = capture_step(dev, body, body)
        self.graphs[key] = (static, graph, outs, per_replay)
        return self.graphs[key]

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        dev = leaves[0].device
        if dev.type != "cuda":
            return self.fn(*args)
        key = (spec, tuple((tuple(v.shape), v.dtype) for v in leaves))
        static, graph, outs, per_replay = self.graphs.get(key) or self._capture(key, leaves, spec, dev)
        for buf, v in zip(static, leaves):
            buf.copy_(v)
        graph.replay()
        add_launch_counts(per_replay)
        return pytree.tree_map(lambda v: v.clone(), outs)


def make_multi_job(k_max: int, n_iters: int = N_ITERS, tile: int = TILE):
    """The engine's step functions for a padded cohort size ``k_max``:
    ``(job_step, batched_step)``.

    * ``job_step(cfg_row, logw, t, g, x) -> (logw, t, out)``: one job on its
      padded ``(K_max,)`` rows, ``g`` its Gumbel row; the reference
      single-job engine.
    * ``batched_step(cfg, state, gs, xs) -> (state, out)``: every job of the
      batch at once, ``gs`` the ``(J, K_max)`` Gumbel rows; on a CUDA device
      one captured graph a shape (see the module docstring).

    Outputs a job: ``idx`` ``(k_max,)`` int32, ``-1`` beyond ``k_j``;
    ``mask`` ``(K_max,)`` 0/1; ``p`` ``(K_max,)`` the allocation drawn
    from; ``capped``.
    """

    def job_step(cfg_row: MultiJobConfig, logw, t, g, x):
        return _step(cfg_row, logw, t, g, x, k_max, n_iters, tile)

    return job_step, _Captured(functools.partial(plain_batched_step, k_max=k_max, n_iters=n_iters, tile=tile))

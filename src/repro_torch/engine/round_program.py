"""One RoundProgram: the paper's round pipeline at local placement (the port
of ``repro.engine.round_program``).

    allocate (ProbAlloc) -> select (Plackett-Luce) -> observe (volatile
    outcomes) -> credit (staleness ring) -> update (E3CS)

* **staleness**: ``None`` is the synchronous deadline-drop round; ``S``
  generalises outcomes to completion lags and carries a bounded ``(S, K)``
  pending-credit ring, crediting a client that completes ``l <= S`` rounds
  late with ``alpha**l``.
* **observe source** (``override``): ``"none"`` (the volatility model),
  ``"dense"`` (a ``(T, K)`` trace: float32 bits, or int32 lags when async),
  ``"packed"`` (1-bit rows, 8 clients a byte) or ``"packed_lags"`` (2-bit
  lag rows, 4 clients a byte).
* **feedback**: ``"deadline"`` (E3CS sees the on-time bits) or
  ``"late_credit"`` (a late client's decayed reward lands at its arrival
  round, at the selection round's importance weight, through a second ring).
* **fused**: the select and tail passes run as the two kernels of
  ``repro_torch.kernels.round_fused``; otherwise the stages run staged.

Noise.  The JAX package splits a carried key each round.  Here the step
takes its noise as tensors (``RoundNoise``: what the scheme's selection
takes, ``fl.round.select_draws``, then the volatility model's uniform rows,
``draw_rows()``), and the runner draws them from one ``torch.Generator`` on
the device in that fixed order each round: ``torch.rand`` rows and 0-d
uniforms, ``torch.randperm`` permutations.  The fused and the staged branch
consume the identical Gumbel row, so they select identically.

On CUDA the fused tail updates the rings in place; ``build_runner`` copies
the rings it is given once, so a caller's rings are never changed.

Placement.  ``mesh=None`` runs the round on one device.  ``mesh=<HostMesh>``
(``repro_torch.launch.mesh``) runs the same round body K-sharded, one
process per rank: the allocator's reductions end in ``psum``/``pmax``
collectives (one per bisection step, or per block of ``block`` halvings,
through the ``bisect_block_sums`` kernel), the cohort is each rank's top-k
merged exactly from a ``(D, k)`` all-gather, and the re-centring max is a
``pmax``.  Where JAX's ``shard_map`` runner takes and returns global
``K_pad``-wide arrays, the port's mesh runner takes and returns this rank's
``(Ks,)`` slab (``K_pad = D * Ks``, zero-padded, the padding frozen by an
``active`` mask; trace rows: ``local_rows``); scalars and cohort indices are
the same on every rank.  The baselines select replicated, as JAX's
``_ShardCtx`` does: random and FedCS from K-wide noise, UCB from its
replicated ``(K,)`` state, pow-d from the all-gathered loss cache; every
rank cuts its slab of the mask from the cohort.  A model shards when its
per-client fields are K-indexed (JAX's ``_collect_k_fields``): Bernoulli,
Markov, deadline, diurnal, flash crowd and regional outage (its region ids),
and the lag views over them.

A runner's noise comes from two streams (``NoiseStreams``) when its key is
an int seed (or what such a runner returned).  Given a ``core.prng.Key``
instead, it follows the JAX package's key stream (``JaxStream``) seed for
seed, in the key's mode: each round ``key, k1, k2 = split(key, 3)``; the
selection draws from ``k1`` (E3CS's Gumbel row, a systematic sampler's
permutation and 0-d uniform from ``split(k1)``, a permutation for random and
pow-d, a uniform row for FedCS) and the volatility model from ``k2`` by its
``key_paths()``; on a mesh of D > 1 ranks E3CS's slab and the model's rows
come from ``fold_in(k1, d)`` and ``fold_in(k2, d)``, every rank drawing the
baselines' K-wide noise from ``k1``, as JAX's shards do (a regional
outage's chain too: per shard).  The rows are drawn final (Gumbel, scaled
uniforms) by the threefry kernel, so their transforms do not run in the
step; a runner keeps the kind of stream of its first call, and a JAX
stream's mode (partitionable or original).

Of the two Philox streams, the own stream draws the rank's ``(Ks,)`` rows (E3CS's Gumbel slab, a model's
per-client rows: those of length K, the rule by which a model's fields
shard); the shared stream draws the rows every rank must hold alike (the
baselines' K-wide permutation or uniform row, a regional outage's
``(n_regions,)`` chain row).  On a mesh of D > 1 ranks the own stream seeds
from ``numpy.random.SeedSequence([seed, d])`` and the shared one from
``seed``, and a ``carry_key`` runner carries both states.  Without a mesh
and at D = 1 the two are one generator, seeded as the dense runner's, each
row drawn in the dense order, so a one-rank mesh with ``block=1`` equals the
dense ``allocator="bisect"`` runner bit for bit, for every scheme (JAX
skips ``fold_in`` at D = 1 for the same reason).  JAX draws a regional
outage's chain from each shard's folded key, so at D > 1 its shards see
different outages; the port's chain is one, replicated.  As in JAX,
``block`` acts only under a mesh.

Taps and sketches.  ``build_step(taps=True)`` and ``build_runner(taps=True,
sketch=SketchSpec(...))`` add the ``ROUND_TAPS`` gauge row, its counters and
the client-axis sketch stream (``repro_torch.obs``) to the round, with the
JAX package's contracts.  They observe values the round computes and never
touch its math or its noise.  Under a mesh the gauges are summed over the
ranks inside the step (one ``all_reduce`` of the stacked gauges a round) and
the sketch stream once after the horizon, so every rank holds the same
stream, and a one-rank mesh emits the dense runner's.

The captured horizon.  ``build_runner``'s ``run`` owns static buffers: the
carry (state, rings and, with taps, counters and sketch accumulators), the
round's raw uniform rows, its trace row and the step's outputs.  Each round
draws its uniform rows from the generator into their buffers (the only
``torch.rand`` calls; the Gumbel and scaling transforms run in the step),
copies its trace row in, runs the step, and copies the outputs into the
``(T, ...)`` results.  On a CUDA device "runs the step" is the replay of a
CUDA graph of the step, captured at the runner's first call after an eager
warm-up on the static buffers (which draws from a generator of its own),
the counterpart of JAX's ``jit`` over ``lax.scan``; on a CPU tensor it is a
call of the same step on the same buffers.  A capture failure raises: a
CUDA runner never loops the step eagerly, except on a mesh whose
collectives a graph cannot hold (a gloo group over CUDA tensors, as two
ranks sharing one card run: ``HostMesh.captures``), which is decided when
the runner is built and read back as ``run.horizon.captured``.  The replayed horizon equals the
eager loop of ``build_step`` + ``draw_noise`` bit for bit, generator state
included.  The kernel wrappers count their launches when the step is
captured; the runner takes the capture's counts back and adds them on every
replay, so ``kernels.launch_counts()`` counts launches that ran.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import FLConfig
from repro_torch.core.selection import (
    E3CSState,
    e3cs_probs,
    e3cs_update,
    fedcs_select,
    make_quota_schedule,
    merge_topk_candidates,
    perturbed_scores,
    pow_d_select,
    random_select,
    selection_mask,
    ucb_init,
    ucb_select,
    ucb_update,
)
from repro_torch.core.prng import Key, PRNGKey, advance_, derive, gumbel, key_data, permutation, split, uniform
from repro_torch.core.selection.e3cs import divide, residual_mass
from repro_torch.core.volatility import DEAD_LAG, row_shape, uniform_rows
from repro_torch.device import resolve_device
from repro_torch.engine.sharded import N_ITERS, TILE, _shard_topk_merge, masked_prob_alloc, masked_prob_alloc_scalars
from repro_torch.fl.round import RoundNoise, init_server_state, make_select_fn, select_draws, select_noise
from repro_torch.kernels import add_launch_counts, launch_counts
from repro_torch.kernels.ref import LAG_DEAD_CODE, ring_pop_push
from repro_torch.kernels.round_fused import MAX_S, fused_alloc_select, fused_perturb_select, fused_round_tail
from repro_torch.kernels.unpack_bits import unpack_bits, unpack_crumbs
from repro_torch.obs.sketches import SKETCH_FIELDS, SketchSpec, lag_bins, region_ids, sketch_carry0, sketch_step
from repro_torch.obs.taps import ROUND_TAPS
from repro_torch.obs.trace import stage

__all__ = [
    "RoundProgram",
    "RoundNoise",
    "NoiseStreams",
    "JaxStream",
    "capture_step",
    "ring_pop_push",
    "lag_credit_schedule",
    "staleness_ring_step",
    "OBSERVE_MODES",
    "FEEDBACK_MODES",
]

OBSERVE_MODES = ("none", "dense", "packed", "packed_lags")
FEEDBACK_MODES = ("deadline", "late_credit")
_f32 = torch.float32


class NoiseStreams(NamedTuple):
    """A runner's noise streams (see the module docstring): ``own`` draws
    the rank's slab rows, ``shared`` the rows every rank draws alike; one
    generator without a mesh and at D = 1."""

    own: torch.Generator
    shared: torch.Generator

    def get_state(self):
        """What a ``carry_key`` runner returns: the generator's state, or
        the ``(own, shared)`` states of two."""
        if self.own is self.shared:
            return self.own.get_state()
        return self.own.get_state(), self.shared.get_state()


class JaxStream:
    """A runner's noise on the JAX package's key stream (``core.prng``): the
    carried key's two words, a ``(2,)`` int32 tensor on the device, in the
    key's mode.  A round's keys are ``split(key, num)`` (``round_keys``);
    then the key advances to the first of them, in place and with no host
    sync: one kernel launch in partitionable mode, in the original mode a
    copy of the round's split, itself one launch."""

    def __init__(self, key: Key, device, num: int = 3):
        self.key = key_data(key).to(device).clone()
        self.partitionable, self.num = key.partitionable, int(num)
        self._round = None

    def get_state(self) -> Key:
        """What a ``carry_key`` runner returns: the advanced key."""
        return Key(self.key.clone(), partitionable=self.partitionable)

    def round_keys(self) -> tuple:
        """This round's ``split(key, num)``, made once a round."""
        if self._round is None:
            self._round = split(Key(self.key, partitionable=self.partitionable), self.num)
        return self._round

    def advance(self) -> None:
        if self.partitionable:
            advance_(self.key)
        else:
            self.key.copy_(self.round_keys()[0].data)
        self._round = None


def lag_credit_schedule(mask, lag, S: int, alpha: float):
    """Decayed-credit rows for this round's selections: row s is
    ``mask * 1{lag == s+1} * alpha**(s+1)``, shape ``(..., S, K)``."""
    decay = torch.stack([torch.full((), alpha ** (s + 1), dtype=_f32, device=mask.device) for s in range(S)])
    lag_rows = torch.arange(1, S + 1, dtype=torch.int32, device=mask.device)
    return mask[..., None, :] * (lag[..., None, :] == lag_rows[:, None]) * decay[:, None]


def staleness_ring_step(pending, mask, lag, S: int, alpha: float):
    """One update of the bounded staleness-credit ring: ``(arriving,
    new_pending)``.  ``S = 0`` is the synchronous no-ring case."""
    if S == 0:
        return torch.zeros_like(mask), pending
    return ring_pop_push(pending, lag_credit_schedule(mask, lag, S, alpha))


class _LocalCtx:
    """Dense single-device stage context: the select and observe stages, and
    collectives that return their argument."""

    def __init__(self, program: "RoundProgram"):
        fl = program.fl
        K, k = fl.K, fl.k
        self.active, self.e3cs_kwargs = None, {}
        if program.fused:
            allocator, quota_fn = fl.allocator, program.quota_fn

            def select(state, noise):
                sigma, g = quota_fn(state.t), noise.g
                if allocator == "bisect":
                    with stage("round.allocate"):
                        w = torch.exp(state.e3cs.logw - torch.max(state.e3cs.logw))
                        scalars = masked_prob_alloc_scalars(w, k, sigma)
                    with stage("round.sample"):
                        p, capped, _, idx = fused_alloc_select(w, g, k, sigma=sigma, scalars=scalars)
                else:
                    with stage("round.allocate"):
                        p, capped = e3cs_probs(state.e3cs, k, sigma)
                    with stage("round.sample"):
                        _, idx = fused_perturb_select(p, g, k)
                return idx, p, capped, sigma, selection_mask(idx, K)

        else:
            base = make_select_fn(fl, program.quota_fn, program.rho)

            def select(state, noise):
                idx, p, capped, sigma = base(state, noise)
                return idx, p, capped, sigma, selection_mask(idx, K)

        self.select = select
        self.observe = _make_observe(program, K)

    @staticmethod
    def psum(v):
        return v

    @staticmethod
    def pmax(v):
        return v

    @staticmethod
    def gather(v):
        return v


class _ShardCtx:
    """This rank's stage context under a mesh: the select and observe stages
    on the rank's ``(Ks,)`` slab, and the mesh's collectives."""

    def __init__(self, program: "RoundProgram", Ks: int):
        fl, mesh = program.fl, program.mesh
        K, k, d, scheme, dev = fl.K, fl.k, mesh.rank, fl.scheme, program.device
        active = (torch.arange(d * Ks, (d + 1) * Ks, device=dev) < K).to(_f32)
        self.active = active
        self.e3cs_kwargs = dict(K=K, mesh=mesh, active=active)
        quota_fn, fused, rho_full = program.quota_fn, program.fused, program.rho
        alloc_kw = dict(active=active, n_iters=N_ITERS, tile=TILE, mesh=mesh, block=program.block)
        neg_inf = torch.full((Ks,), float("-inf"), dtype=_f32, device=dev)

        def gather(v):  # the ranks' slabs side by side, cut to the K clients
            return mesh.all_gather(v)[:K]

        def select_e3cs(state, sigma, g):
            with stage("round.allocate"):
                logw = state.e3cs.logw
                w = torch.exp(logw - mesh.pmax(torch.max(torch.where(active > 0, logw, neg_inf)))) * active
                if fused:
                    scalars = masked_prob_alloc_scalars(w, k, sigma, **alloc_kw)
                else:
                    p, capped = masked_prob_alloc(w, k, sigma, **alloc_kw)
            with stage("round.sample"):
                if fused:
                    # the allocation epilogue, perturbation and local top-k in one
                    # kernel; only the scalars and the (D, k) candidates cross ranks
                    p, capped, vals, loc = fused_alloc_select(w, g, k, sigma=sigma, scalars=scalars, active=active)
                    idx = merge_topk_candidates(mesh.all_gather(vals), mesh.all_gather(loc + d * Ks), k)
                else:
                    idx = _shard_topk_merge(torch.where(active > 0, perturbed_scores(g, p), neg_inf), k, mesh)
            return idx, p, capped

        def select(state, noise):
            sigma = quota_fn(state.t)
            if scheme == "e3cs":
                idx, p, capped = select_e3cs(state, sigma, noise.g)
            elif scheme == "random":
                idx = random_select(noise.perm, K, k)
            elif scheme == "fedcs":
                idx = fedcs_select(rho_full, k, noise.v)
            elif scheme == "ucb":
                idx = ucb_select(state.ucb, k)
            else:
                idx = pow_d_select(noise.perm, gather(state.loss_cache), k, fl.pow_d)
            loc = idx - d * Ks
            valid = ((loc >= 0) & (loc < Ks)).to(_f32)
            mask = torch.zeros(Ks, dtype=_f32, device=dev).scatter_reduce_(
                0, torch.clamp(loc, 0, Ks - 1).long(), valid, reduce="amax"
            )
            if scheme != "e3cs":
                capped = torch.zeros(Ks, dtype=torch.bool, device=dev)
                p = torch.full((Ks,), k / K, dtype=_f32, device=dev) if scheme == "random" else mask
            return idx, p, capped, sigma, mask

        # the stages close over locals, never over ``self``: a context in a
        # reference cycle would hold its tensors (and a replaced engine's)
        # until the collector ran
        self.select, self.gather = select, gather
        self.observe = _make_observe(program, Ks)
        self.psum, self.pmax = mesh.psum, mesh.pmax


def _make_observe(program: "RoundProgram", K: int):
    """The observe stage: ``observe(x_over, us, vol_state) -> (outcome,
    vol_state)``, success bits (sync) or lags (async) from the configured
    source, over ``K`` clients (the rank's slab under a mesh)."""
    mode, vol = program.override, program.local_vol
    is_async = program.staleness is not None

    if mode == "none":

        def observe(x_over, us, vs):
            return vol.sample(us, vs)

    elif mode == "dense":

        def observe(x_over, us, vs):
            return (x_over.to(torch.int32) if is_async else x_over), vs

    elif mode == "packed":

        def observe(x_over, us, vs):
            return unpack_bits(x_over, K), vs

    else:  # packed_lags

        def observe(x_over, us, vs):
            codes = unpack_crumbs(x_over, K)
            return torch.where(codes == LAG_DEAD_CODE, torch.full_like(codes, DEAD_LAG), codes), vs

    return observe


def _make_step(program: "RoundProgram", ctx, lean: bool, taps: bool = False, sketch: Optional[SketchSpec] = None,
               region=None):
    """The round body ``step(carry, x_over, noise) -> (carry, out)``: the
    single copy of the round pipeline that ``build_runner`` runs.

    Sync carry is ``(state,)``, async ``(state, rings)`` with ``rings`` the
    ``(credit,)`` or ``(credit, feedback)`` tuple of ``init_rings``.  Outputs
    per round: sync full ``(mask, x, p, sigma)``, sync lean ``(on_time,
    sigma)``, async full ``(mask, lag, p, sigma, arriving)``, async lean
    ``(on_time, stale, sigma)``.  Under a mesh the per-client arrays are the
    rank's slab, and the lean scalars are summed over the ranks.

    With ``taps=True`` the carry gains a trailing ``ROUND_TAPS`` counter
    dict and the outputs a trailing gauge row (a dict of 0-d tensors, summed
    over the ranks under a mesh).  With ``sketch`` (requires taps) the carry
    further gains the rank's sketch accumulators and the outputs a trailing
    sketch row of the rank's partial sums, zeros except on every
    ``sketch.window``-th round (``repro_torch.obs.sketches``); ``region`` is
    the rank's ``(K_loc,)`` region ids.
    """
    fl = program.fl
    k, eta, K, scheme = fl.k, fl.eta, fl.K, fl.scheme
    sync = program.staleness is None
    S = 0 if sync else int(program.staleness)
    alpha = program.alpha
    late_fb = (not sync) and program.feedback == "late_credit" and scheme == "e3cs" and S > 0
    fused = program.fused
    if fused:
        decay = tuple(alpha ** (s + 1) for s in range(S))
        kind = {"packed": "bits", "packed_lags": "crumbs"}.get(program.override, "x" if sync else "lag")
    if sketch is not None:
        L = lag_bins(program.staleness)

    active = ctx.active

    def tap_row(mask, x, sigma, capped, arriving=None):
        """The gauge row: the slab's sums stacked, one collective a round."""
        stale = torch.zeros((), dtype=_f32, device=mask.device) if arriving is None else torch.sum(arriving)
        sums = ctx.psum(torch.stack([torch.sum(mask), torch.dot(mask, x), stale, torch.sum(capped.to(_f32))]))
        return {
            "selected": sums[0],
            "on_time": sums[1],
            "stale": sums[2],
            "sigma": sigma.to(_f32),
            "capped_frac": divide(sums[3], K),
        }

    def with_taps(carry, out, tapc, skc, mask, x, lag, p, sigma, capped, state, arriving=None):
        if not taps:
            return carry, out
        row = tap_row(mask, x, sigma, capped, arriving)
        carry, out = carry + (ROUND_TAPS.accumulate(tapc, row),), out + (row,)
        if sketch is None:
            return carry, out
        skc, sk_row = sketch_step(sketch, skc, mask, x, lag, p, state.sel_counts, state.t, region, active, L)
        return carry + (skc,), out + (sk_row,)

    def recentre(logw):
        """Shift to a (masked, global) max of 0; padding stays pinned at 0."""
        if active is None:
            return logw - torch.max(logw)
        m = torch.max(torch.where(active > 0, logw, torch.full_like(logw, float("-inf"))))
        return (logw - ctx.pmax(m)) * active

    def step(carry, x_over, noise: RoundNoise):
        state = carry[0]
        rings = None if sync else carry[1]
        n_core = 1 if sync else 2
        tapc = carry[n_core] if taps else None
        skc = carry[n_core + 1] if sketch is not None else None
        with stage("round.select"):
            idx, p, capped, sigma, mask = ctx.select(state, noise)
        if fused:
            with stage("round.observe"):
                if kind in ("bits", "crumbs"):
                    obs, vs = x_over, state.vol_state  # the tail kernel decodes the raw bytes
                else:
                    obs, vs = ctx.observe(x_over, noise.u, state.vol_state)
            with stage("round.update"):
                residual = residual_mass(k, K, sigma)
                tail = fused_round_tail(
                    obs, mask, p, capped, state.e3cs.logw, state.loss_cache,
                    rings[0] if S > 0 else None, rings[1] if late_fb else None,
                    kind=kind, residual=residual, eta=eta, K_glob=K, decay=decay, active=active,
                )
                x = tail["x"]
                logw = tail["logw_pre"] - ctx.pmax(tail["m"])
                e3cs = E3CSState(logw=logw if active is None else logw * active, t=state.e3cs.t + 1)
                loss_cache = tail["loss_cache"]
                ucb = state.ucb
            if not sync:
                lag = tail["lag"]
                with stage("round.credit"):
                    if S == 0:
                        arriving, new_rings = torch.zeros_like(mask), (rings[0],)
                    else:
                        arriving, new_rings = tail["arriving"], (tail["credit"],)
                    if late_fb:
                        e3cs = e3cs._replace(logw=recentre(e3cs.logw + tail["arr_fb"]))
                        new_rings = new_rings + (tail["fb"],)
        else:
            with stage("round.observe"):
                obs, vs = ctx.observe(x_over, noise.u, state.vol_state)
            if sync:
                x = obs
            else:
                lag = obs
                x = (lag == 0).to(_f32)  # deadline-based selector feedback
            with stage("round.update"):
                e3cs = state.e3cs
                if scheme == "e3cs":
                    e3cs = e3cs_update(state.e3cs, p, capped, mask, x, k, sigma, eta, **ctx.e3cs_kwargs)
                loss_cache = torch.where(mask > 0, 1.0 - x, state.loss_cache)  # the pow-d loss proxy
                ucb = ucb_update(state.ucb, idx, ctx.gather(x)) if scheme == "ucb" else state.ucb
            if not sync:
                with stage("round.credit"):
                    if S == 0:
                        arriving, pending = torch.zeros_like(mask), rings[0]
                    else:
                        sched = lag_credit_schedule(mask, lag, S, alpha)
                        arriving, pending = ring_pop_push(rings[0], sched)
                    new_rings = (pending,)
                    if late_fb:
                        # the selection round's importance weight, buffered next to the credit
                        xhat_rows = sched / torch.clamp(p, min=1e-12)
                        rows = torch.clamp(divide(residual_mass(k, K, sigma) * eta * xhat_rows, K), max=1.0)
                        frozen = capped if active is None else capped | (active == 0)
                        rows = torch.where(frozen, torch.zeros_like(rows), rows)
                        arriving_fb, fb = ring_pop_push(rings[1], rows)
                        e3cs = e3cs._replace(logw=recentre(e3cs.logw + arriving_fb))
                        new_rings = (pending, fb)
        if sync:
            state = state._replace(
                e3cs=e3cs, ucb=ucb, vol_state=vs, t=state.t + 1, sel_counts=state.sel_counts + mask,
                loss_cache=loss_cache,
            )
            out = (ctx.psum(torch.dot(mask, x)), sigma) if lean else (mask, x, p, sigma)
            return with_taps((state,), out, tapc, skc, mask, x, None, p, sigma, capped, state)
        on_time = ctx.psum(torch.dot(mask, x))
        stale = ctx.psum(torch.sum(arriving))
        state = state._replace(
            e3cs=e3cs, ucb=ucb, vol_state=vs, t=state.t + 1, sel_counts=state.sel_counts + mask,
            loss_cache=loss_cache, cep=state.cep + on_time + stale, succ_hist=state.succ_hist + on_time,
        )
        out = (on_time, stale, sigma) if lean else (mask, lag, p, sigma, arriving)
        return with_taps((state, new_rings), out, tapc, skc, mask, x, lag, p, sigma, capped, state, arriving)

    return step


def _collect_k_fields(vol, K: int, prefix: str = "") -> dict:
    """Dotted names of the model's per-client ``(K, ...)`` tensor fields,
    recursing into nested dataclass fields (``CompletionLag.base.rho``)."""
    if not dataclasses.is_dataclass(vol):
        raise TypeError(
            f"sharded rounds need a dataclass volatility model with (K,)-indexed tensor fields "
            f"(bernoulli, or a lag wrapper over it), got {type(vol).__name__}; replay traces through "
            f"override='packed' / 'packed_lags' instead"
        )
    out = {}
    for f in dataclasses.fields(vol):
        v = getattr(vol, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            out.update(_collect_k_fields(v, K, prefix + f.name + "."))
        elif isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == K:
            out[prefix + f.name] = v
    return out


def _rebuild_vol(vol, arrs: dict):
    """Replace the (possibly nested) fields named by ``_collect_k_fields``
    with their per-rank slabs."""
    if not arrs:
        return vol
    groups: dict = {}
    for name, a in arrs.items():
        head, _, rest = name.partition(".")
        if rest:
            groups.setdefault(head, {})[rest] = a
        else:
            groups[head] = a
    kw = {head: _rebuild_vol(getattr(vol, head), v) if isinstance(v, dict) else v for head, v in groups.items()}
    return dataclasses.replace(vol, **kw)


def _slab(a: torch.Tensor, K_pad: int, rank: int, Ks: int, dim: int = -1) -> torch.Tensor:
    """Rank ``rank``'s ``Ks`` entries along ``dim`` of ``a`` zero-padded to
    ``K_pad`` entries there."""
    pad = K_pad - a.shape[dim]
    if pad:
        shape = list(a.shape)
        shape[dim] = pad
        a = torch.cat([a, a.new_zeros(shape)], dim=dim)
    return a.narrow(dim, rank * Ks, Ks).contiguous()


@dataclasses.dataclass
class RoundProgram:
    """A composed round pipeline; see the module docstring.

    ``vol`` is the observe model: a success-bit model when synchronous, a lag
    model when ``staleness`` is set.  For trace overrides it only seeds
    ``vol_state``.  ``mesh`` is a ``repro_torch.launch.mesh.HostMesh`` (K-
    sharded, this process's rank) or None.  ``device=None`` means CUDA (the
    mesh's device under a mesh), and raises without it; the tests pass
    ``device="cpu"``.
    """

    fl: FLConfig
    vol: object
    rho: object
    override: str = "none"
    staleness: Optional[int] = None
    alpha: float = 0.5
    feedback: str = "deadline"
    mesh: Optional[object] = None
    block: int = 1
    fused: bool = False
    base_vol: object = None
    quota_fn: object = None  # override; default derives the schedule from fl
    device: object = None

    def __post_init__(self):
        mesh = self.mesh
        if mesh is None:
            self.device = resolve_device(self.device)
        else:
            dev = mesh.device if self.device is None else resolve_device(self.device)
            if dev.type != mesh.device.type or dev.index not in (None, mesh.device.index):
                raise ValueError(f"device {dev} is not this rank's mesh device {mesh.device}")
            self.device = mesh.device
        if self.block < 1:
            raise ValueError(f"block must be at least 1, got {self.block}")
        if self.fused:
            if self.fl.scheme != "e3cs":
                raise ValueError(
                    "fused=True fuses the E3CS allocate/perturb/update stages; "
                    f"scheme {self.fl.scheme!r} has nothing to fuse"
                )
            if self.fl.sampler != "plackett_luce":
                raise ValueError("fused=True implements the plackett_luce (Gumbel top-k) sampler only")
            if self.staleness is not None and int(self.staleness) > MAX_S:
                raise ValueError(f"the fused tail kernel takes staleness rings of at most {MAX_S} slots")
        if self.override not in OBSERVE_MODES:
            raise ValueError(f"unknown override mode {self.override!r} (want one of {OBSERVE_MODES})")
        if self.feedback not in FEEDBACK_MODES:
            raise ValueError(f"unknown feedback policy {self.feedback!r} (want one of {FEEDBACK_MODES})")
        if self.staleness is None and self.override == "packed_lags":
            raise ValueError("override='packed_lags' replays completion lags; it needs staleness=S (async rounds)")
        if self.staleness is not None and self.override == "packed":
            raise ValueError("async rounds replay 2-bit lag traces: use override='packed_lags', not 'packed'")
        if self.feedback == "late_credit" and self.staleness is None:
            raise ValueError(
                "feedback='late_credit' buffers selection-round allocations in the staleness "
                "ring; it needs staleness=S (S=0 degenerates to deadline feedback)"
            )
        select_draws(self.fl, self.fl.K)  # raises for an unknown scheme or sampler
        if mesh is not None and self.fl.scheme == "e3cs" and self.fl.sampler != "plackett_luce":
            raise ValueError("the sharded engine only implements the plackett_luce sampler")
        self.vol = self.vol.to(self.device)
        self.rho = torch.as_tensor(self.rho, dtype=_f32, device=self.device) if self.rho is not None else None
        if self.quota_fn is None:
            fl = self.fl
            self.quota_fn = make_quota_schedule(fl.quota, fl.k, fl.K, fl.rounds, fl.quota_frac, device=self.device)
        self.local_vol = self.vol
        if mesh is not None:
            K_pad, Ks, _, _ = self._sharded_geometry()
            if self.fl.scheme == "e3cs" and self.fl.k > Ks:
                raise ValueError(f"k={self.fl.k} exceeds the shard width {Ks}; need k <= K_pad/D for per-shard top-k")
            if self.override == "none":  # a model without (K,)-indexed fields raises TypeError here, as in JAX
                fields = _collect_k_fields(self.vol, self.fl.K)
                self.local_vol = _rebuild_vol(
                    self.vol, {n: _slab(a, K_pad, mesh.rank, Ks, dim=0) for n, a in fields.items()}
                )

    @classmethod
    def from_config(
        cls, fl_cfg: FLConfig, volatility=None, mesh=None, feedback: str = "deadline", override: str = "none",
        device=None, **engine_opts,
    ) -> "RoundProgram":
        """Resolve an ``FLConfig`` into a program: ``fl_cfg.volatility`` (or
        ``volatility``) by ``build_volatility``; ``staleness_rounds > 0``
        wraps the model in ``CompletionLag(late_prob, lag_decay, max_lag=S)``
        and selects the async round; 0 is the synchronous program.  A mesh
        forces the sort-free ``allocator="bisect"`` (the sharded round has no
        sorted path)."""
        from repro_torch.core.volatility import CompletionLag
        from repro_torch.fl.server import build_volatility

        device = resolve_device(device) if mesh is None or device is not None else mesh.device
        vol, rho = build_volatility(fl_cfg, fl_cfg.K, volatility=volatility, device=device)
        if mesh is not None and fl_cfg.allocator != "bisect":
            fl_cfg = dataclasses.replace(fl_cfg, allocator="bisect")
        S = int(fl_cfg.staleness_rounds)
        base_vol = vol
        staleness: Optional[int] = None
        if S > 0:
            staleness = S
            vol = CompletionLag(vol, p_late=fl_cfg.late_prob, lag_decay=fl_cfg.lag_decay, max_lag=S)
        return cls(
            fl=fl_cfg, vol=vol, rho=rho, override=override, staleness=staleness,
            alpha=float(fl_cfg.staleness_alpha), feedback=feedback, mesh=mesh, base_vol=base_vol, device=device,
            **engine_opts,
        )

    def _sharded_geometry(self):
        """``(K_pad, Ks, width, D)``: padded population, per-rank width, trace
        row width, mesh size.  The byte-packed modes pad K to whole bytes of
        every rank."""
        K, D = self.fl.K, self.mesh.size
        if self.override in ("packed", "packed_lags"):
            cpb = 8 if self.override == "packed" else 4  # clients per byte
            B_loc = -(-((K + cpb - 1) // cpb) // D)
            return cpb * B_loc * D, cpb * B_loc, B_loc * D, D
        K_pad = D * (-(-K // D))
        return K_pad, K_pad // D, K_pad, D

    @property
    def lag_model(self):
        """The lag model driving async rounds (None when synchronous)."""
        return self.vol if self.staleness is not None else None

    def select_fn(self):
        """The dense per-round ``select(state, noise) -> (idx, p, capped,
        sigma)``: the allocate + select stages for host-driven loops (the FL
        training server gathers the cohort's data between select and
        train)."""
        return make_select_fn(self.fl, self.quota_fn, self.rho)

    @property
    def K_loc(self) -> int:
        """Per-client width of this process's arrays: ``fl.K``, or the rank's
        slab ``Ks`` under a mesh."""
        return self.fl.K if self.mesh is None else self._sharded_geometry()[1]

    def local_rows(self, xs) -> torch.Tensor:
        """This process's columns of ``(T, width)`` trace rows (a ``(T, K)``
        dense trace or ``(T, ceil(K/8))`` / ``(T, ceil(K/4))`` packed bytes),
        zero-padded to the mesh's width, as a tensor on the device.  At local
        placement: the rows as they are."""
        xs = torch.as_tensor(xs, device=self.device)
        if self.mesh is None:
            return xs
        _, _, width, D = self._sharded_geometry()
        return _slab(xs, width, self.mesh.rank, width // D)

    def init_rings(self):
        """Zeroed async rings: ``(credit,)``, plus the feedback ring under
        ``feedback='late_credit'``, each ``(S, K_loc)`` on the device (the
        rank's slab under a mesh)."""
        S = 0 if self.staleness is None else int(self.staleness)
        shape = (S, self.K_loc)
        rings = (torch.zeros(shape, dtype=_f32, device=self.device),)
        if self.feedback == "late_credit" and self.fl.scheme == "e3cs" and S > 0:
            rings = rings + (torch.zeros(shape, dtype=_f32, device=self.device),)
        return rings

    def generator(self, key, num: int = 3):
        """The runner's noise on the device: a ``JaxStream`` from a
        ``core.prng.Key`` (``num`` keys split a round); else
        ``NoiseStreams`` from an int seed or from what a ``carry_key``
        runner returned: one generator seeded from ``seed``, or on a mesh of
        D > 1 ranks the own stream seeded from ``SeedSequence([seed, d])``
        and the shared one from ``seed``."""
        if isinstance(key, Key):
            return JaxStream(key, self.device, num)
        if self.mesh is None or self.mesh.size == 1:
            gen = torch.Generator(device=self.device)
            if isinstance(key, torch.Tensor):
                gen.set_state(key)
            else:
                gen.manual_seed(int(key))
            return NoiseStreams(gen, gen)
        own, shared = torch.Generator(device=self.device), torch.Generator(device=self.device)
        if isinstance(key, tuple):
            own.set_state(key[0])
            shared.set_state(key[1])
        else:
            own.manual_seed(int(np.random.SeedSequence([int(key), self.mesh.rank]).generate_state(1, np.uint64)[0]))
            shared.manual_seed(int(key))
        return NoiseStreams(own, shared)

    def _model_rows(self) -> tuple:
        """The volatility model's ``(n, lo)`` rows (none when outcomes come
        from a trace)."""
        return self.local_vol.draw_rows() if self.override == "none" else ()

    def _select_width(self) -> int:
        """Clients a selection draw covers: E3CS's Gumbel row is the rank's
        slab, a baseline's noise covers all K clients on every rank."""
        return self.K_loc if self.fl.scheme == "e3cs" else self.fl.K

    def draws(self) -> tuple:
        """One round's raw draws in the fixed order, each ``("rand" |
        "perm", shape)``: the selection's (``select_draws``), then the
        volatility model's rows (only when outcomes come from the model)."""
        rows = tuple(("rand", row_shape(n)) for n, _ in self._model_rows())
        return select_draws(self.fl, self._select_width()) + rows

    def _shared_draws(self) -> tuple:
        """For each of ``draws()``, whether the shared stream draws it: the
        baselines' selection noise, and a model's rows that are not per
        client (a regional outage's chain row)."""
        n_sel = len(select_draws(self.fl, self._select_width()))
        per_client = (self.fl.K,)
        rows = self.vol.draw_rows() if self.override == "none" else ()
        return (self.fl.scheme != "e3cs",) * n_sel + tuple(row_shape(n) != per_client for n, _ in rows)

    def _draw_buffers(self) -> list:
        return [torch.empty(shape, dtype=torch.int64 if kind == "perm" else _f32, device=self.device)
                for kind, shape in self.draws()]

    def _jax_draws(self, vol_path: tuple = (2,)) -> tuple:
        """For each of ``draws()``, how the JAX key stream draws it: ``(mode,
        path, lo)``, the path from the round's split (its first step the
        index of a round key, ``1`` for ``k1``; then ``core.prng.derive``'s
        steps, an int a fold and ``(i, n)`` a split; ``vol_path`` leads to
        the key the volatility model's ``sample`` takes, ``k2`` in a runner)
        and a uniform row's lower end (see the module docstring)."""
        fl = self.fl
        fold = (self.mesh.rank,) if self.mesh is not None and self.mesh.size > 1 else ()
        if fl.scheme == "e3cs":
            sel = (("gumbel", (1,) + fold, 0.0),) if fl.sampler == "plackett_luce" else (
                ("perm", (1, (0, 2)), 0.0), ("uniform", (1, (1, 2)), 0.0))
        else:
            sel = {"random": (("perm", (1,), 0.0),), "fedcs": (("uniform", (1,), 0.0),),
                   "pow_d": (("perm", (1,), 0.0),), "ucb": ()}[fl.scheme]
        if self.override != "none":
            return sel
        vol = self.local_vol
        rows = zip(vol.key_paths(), vol.draw_rows())
        return sel + tuple(("uniform", tuple(vol_path) + fold + path, lo) for path, (_, lo) in rows)

    def _draw_jax(self, gen: JaxStream, out, vol_path: tuple = (2,)) -> tuple:
        """One round's noise from the JAX key stream, drawn final into
        ``out``, then the key advanced."""
        for (mode, path, lo), (_, shape), buf in zip(self._jax_draws(vol_path), self.draws(), out):
            key = derive(gen.round_keys()[path[0]], path[1:])
            if mode == "perm":
                permutation(key, shape[0], out=buf)
            elif mode == "gumbel":
                gumbel(key, shape, out=buf)
            else:
                uniform(key, shape, minval=lo, out=buf)
        gen.advance()
        return tuple(out)

    def draw_uniforms(self, gen, out=None, vol_path: tuple = (2,)) -> tuple:
        """One round's raw draws (``draws``): ``torch.rand`` rows and 0-d
        uniforms, ``torch.randperm`` permutations, each from its stream of
        ``gen`` (``generator``); from a ``JaxStream``, the JAX package's
        rows, drawn final (``noise_from_uniforms(..., final=True)`` reads
        them), the model's under ``vol_path`` (``_jax_draws``).  With
        ``out`` they are drawn into those buffers."""
        out = self._draw_buffers() if out is None else out
        if isinstance(gen, JaxStream):
            return self._draw_jax(gen, out, vol_path)
        for (kind, shape), shared, buf in zip(self.draws(), self._shared_draws(), out):
            g = gen.shared if shared else gen.own
            if kind == "perm":
                torch.randperm(shape[0], generator=g, out=buf)
            else:
                torch.rand(shape, generator=g, out=buf)
        return tuple(out)

    def noise_from_uniforms(self, raw, final: bool = False) -> RoundNoise:
        """The round's noise from its raw draws: the selection's fields
        (``select_noise``), then the model's scaling of its rows; with
        ``final`` (the JAX key stream's rows) the rows as they are."""
        n_sel = len(select_draws(self.fl, self._select_width()))
        if final:
            sel = {"g": raw[0]} if self.fl.scheme == "e3cs" and self.fl.sampler == "plackett_luce" else select_noise(
                self.fl, raw[:n_sel])
            return RoundNoise(**sel, u=tuple(raw[n_sel:]))
        return RoundNoise(**select_noise(self.fl, raw[:n_sel]), u=uniform_rows(raw[n_sel:], self._model_rows()))

    def draw_noise(self, gen, vol_path: tuple = (2,)) -> RoundNoise:
        """One round's noise, drawn in the fixed order (``draws``)."""
        return self.noise_from_uniforms(self.draw_uniforms(gen, vol_path=vol_path), final=isinstance(gen, JaxStream))

    def _state0(self):
        if self.mesh is None:
            return init_server_state({}, self.fl.K, self.vol.init_state(), self.device)
        K_pad, Ks, _, _ = self._sharded_geometry()
        vs = pytree.tree_map(
            lambda v: _slab(v, K_pad, self.mesh.rank, Ks, dim=0)
            if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == self.fl.K else v,
            self.vol.init_state(),
        )
        # UCB's small (K,) state is replicated, as in JAX
        return init_server_state({}, Ks, vs, self.device)._replace(ucb=ucb_init(self.fl.K, self.device))

    def _step(self, lean: bool, taps: bool, sketch: Optional[SketchSpec] = None):
        ctx = _LocalCtx(self) if self.mesh is None else _ShardCtx(self, self.K_loc)
        region = None
        if sketch is not None:
            region = torch.as_tensor(region_ids(sketch, self.fl.K), device=self.device)
            if self.mesh is not None:
                K_pad, Ks, _, _ = self._sharded_geometry()
                region = _slab(region, K_pad, self.mesh.rank, Ks)
        return _make_step(self, ctx, lean, taps, sketch, region)

    def build_step(self, lean: bool = False, taps: bool = False):
        """The round body ``step(carry, x_over, noise)`` plus its initial
        state (see ``_make_step`` for the carry and outputs); under a mesh,
        this rank's step and slab.  With ``taps=True`` the carry gains a
        trailing counter dict (seed it with ``ROUND_TAPS.init_counters(
        device)``) and the outputs a trailing gauge row."""
        return self._step(lean, taps), self._state0()

    def build_runner(self, outputs: str = "full", carry_key: bool = False, scan_length: Optional[int] = None,
                     taps: bool = False, sketch: Optional[SketchSpec] = None):
        """The program over a whole horizon; returns ``(run, state0)``.

        * sync  full: ``run(state, key, xs_in=None) -> (state, masks, xs, ps, sigmas)``
        * sync  lean: ``... -> (state, successes, sigmas)``
        * async full: ``... -> (state, masks, lags, ps, sigmas, arrived)``
        * async lean: ``... -> (state, on_time, stale, sigmas)``

        ``key`` is an int seed or a generator state, or a ``core.prng.Key``
        for the JAX package's key stream.  ``carry_key=True`` threads the
        generator state or the key (and, async, the rings) through so a
        chunked horizon equals a one-shot one: sync ``run(state, key, xs_in)
        -> (state, key, *outs)``, async ``run(state, key, rings, xs_in) ->
        (state, key, rings, *outs)`` (seed rings with ``init_rings``).
        ``xs_in`` holds the ``(T, ...)`` trace rows of the override modes.
        ``scan_length`` runs that many rounds instead of ``fl.rounds``.

        ``taps=True`` appends one payload to every contract above,
        ``{"series": {gauge: (T,)}, "counters": {counter: 0-d}}``, the
        ``ROUND_TAPS`` schema.  With ``carry_key=True`` the counters thread
        through instead (seed them with ``ROUND_TAPS.init_counters(device)``):
        sync ``run(state, key, tapc, xs_in) -> (state, key, tapc, *outs,
        series)``, async ``run(state, key, rings, tapc, xs_in) -> (state,
        key, rings, tapc, *outs, series)``; chunks concatenated equal one
        shot.  ``sketch=<SketchSpec>`` (requires ``taps``, one-shot only)
        adds ``"sketches"``: ``SKETCH_FIELDS`` to ``(T // window, ...)``
        streams, summed over the ranks under a mesh.

        Under a mesh every per-client array in and out (state, rings, trace
        rows, full outputs) is this rank's slab: ``local_rows`` cuts trace
        rows, ``repro_torch.convert`` shards and gathers states.

        The returned ``run`` keeps its static buffers and, on CUDA, the graph
        it captures at its first call (``run.horizon``: ``captured``,
        ``warmup_s``, ``capture_s``, ``per_replay`` launches; a gloo mesh's
        runner is not captured); nothing ``run`` returns aliases them.
        """
        if outputs not in ("full", "lean"):
            raise ValueError(f"unknown outputs mode {outputs!r} (want 'full' or 'lean')")
        if sketch is not None and not taps:
            raise ValueError("sketch streams ride the taps stage; pass taps=True")
        if sketch is not None and carry_key:
            raise ValueError(
                "sketch streams are one-shot (the windowed emission is sliced after the horizon); "
                "chunked carry_key horizons stream taps counters instead"
            )
        T = self.fl.rounds if scan_length is None else int(scan_length)
        if T < 1:
            raise ValueError(f"a horizon runs at least one round, got {T}")
        step = self._step(outputs == "lean", taps, sketch)
        sync = self.staleness is None
        replay = self.override != "none"
        captured = self.device.type == "cuda" and (self.mesh is None or self.mesh.captures)
        horizon = _Horizon(self, step, T, n_sketch=len(SKETCH_FIELDS) if sketch is not None else 0,
                           captured=captured)

        def run_horizon(carry, key, xs_in):
            if replay and (xs_in is None or len(xs_in) < T):
                raise ValueError(f"override={self.override!r} needs {T} trace rows in xs_in")
            gen = self.generator(key)
            carry, outs = horizon(carry, gen, xs_in if replay else None)
            return carry, gen, outs

        if carry_key:
            n_carry = int(not sync) + int(taps)  # rings and counters the caller threads

            def run(state, key, *args, xs_in=None):
                if len(args) == n_carry + 1 and xs_in is None:
                    *args, xs_in = args
                if len(args) != n_carry:
                    raise TypeError(f"run takes state, key, {n_carry} carried value(s) and xs_in; got {len(args)}")
                carry, gen, outs = run_horizon((state, *args), key, xs_in)
                return (carry[0], gen.get_state(), *carry[1:], *outs)

        else:
            n_core = 1 if sync else 2

            def run(state, key, xs_in=None):
                tail = (ROUND_TAPS.init_counters(self.device),) if taps else ()
                if sketch is not None:
                    tail += (sketch_carry0(self.K_loc, lag_bins(self.staleness), self.device),)
                rings = () if sync else (self.init_rings(),)
                carry, _, outs = run_horizon((state, *rings, *tail), key, xs_in)
                if not taps:
                    return (carry[0], *outs)
                payload = {"counters": carry[n_core]}
                if sketch is not None:
                    *outs, series, sk = outs
                    payload["sketches"] = self._merge_stream(sk, sketch.window)
                else:
                    *outs, series = outs
                return (carry[0], *outs, {"series": series, **payload})

        run.horizon = horizon
        return run, self._state0()

    def _merge_stream(self, sk: dict, W: int) -> dict:
        """The emission rows of a sketch stream (every ``W``-th round), summed
        over the ranks under a mesh: one collective for all fields."""
        sk = {n: v[W - 1 :: W] for n, v in sk.items()}
        if self.mesh is None:
            return {n: v.contiguous() for n, v in sk.items()}
        n = next(iter(sk.values())).shape[0]
        flat = self.mesh.psum(torch.cat([v.reshape(n, -1) for v in sk.values()], dim=1))
        out, col = {}, 0
        for name, v in sk.items():
            w = int(np.prod(v.shape[1:]))
            out[name] = flat[:, col : col + w].reshape(v.shape).contiguous()
            col += w
        return out


_WARMUP_STREAMS: dict = {}  # device index -> the side stream every capture on it warms up on


def capture_step(dev: torch.device, warm_up, body):
    """``body()`` captured as a CUDA graph on ``dev``, after ``warm_up()``
    (which runs ``body`` once) on a side stream: allocator pools, library
    handles and the NCCL communicator come to exist there, outside the
    capture.  The kernel launches the capture counted are taken back: a
    replay's run when it is replayed, and the caller adds them then.
    Returns ``(graph, body's outputs, launches a replay, warm-up s,
    capture s)``; a capture that fails raises.

    Every warm-up on a device runs on one side stream: cuBLAS keeps a
    workspace (32 MiB on the card) for each stream a ``dot`` has run on, for
    the life of the process, so a fresh stream a capture would leave one
    behind at every capture (a restarted serving engine's, each time)."""
    with torch.cuda.device(dev):
        main = torch.cuda.current_stream(dev)
        index = torch.cuda.current_device()
        side = _WARMUP_STREAMS.get(index)
        if side is None:
            side = _WARMUP_STREAMS[index] = torch.cuda.Stream(index)
        side.wait_stream(main)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            warm_up()
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outs = body()
        torch.cuda.synchronize(dev)
        after = launch_counts()
    per_replay = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    add_launch_counts({n: -c for n, c in per_replay.items()})
    return graph, outs, per_replay, t1 - t0, time.perf_counter() - t1


class _Horizon:
    """The rounds of one runner over static buffers (see the module
    docstring): ``horizon(carry, gen, xs_in) -> (carry, outs)`` runs ``T``
    rounds of ``step`` from ``carry``, with noise from ``gen`` and trace rows
    from ``xs_in`` (None without a trace), and returns the new carry and the
    ``(T, ...)`` outputs in the step's structure.  The carry it is given is
    copied in and never written.

    The step's 0-d float32 outputs and its last ``n_sketch`` outputs (the
    sketch row) are packed into one vector a round, so a round takes its
    outputs out in one copy per per-client output and one for the rest.
    """

    def __init__(self, program: "RoundProgram", step, T: int, n_sketch: int = 0, captured: bool = False):
        self.program, self.step, self.T, self.n_sketch = program, step, T, n_sketch
        self.captured = captured  # replay a CUDA graph of the step, or call it on the buffers
        self.graph = None
        self.warmup_s = self.capture_s = None
        self.per_replay = {}  # kernel launches by wrapper that one replay runs
        self._spec = None
        # whether the runner's noise is the JAX key stream, and in which mode (fixed at its first call)
        self.jax_stream = self.partitionable = None

    def _setup(self, leaves, spec, xs_in):
        pm = self.program
        self._spec = spec
        self._carry = [v.detach().clone() if torch.is_tensor(v) else v for v in leaves]
        self._x = None if xs_in is None else torch.as_tensor(xs_in[0], device=pm.device).clone()
        self._raw = pm._draw_buffers()

    def _body(self):
        """One step on the static buffers: the new carry is written back into
        them, and the outputs are returned as ``(per-client list, packed)``."""
        noise = self.program.noise_from_uniforms(self._raw, final=self.jax_stream)
        carry, out = self.step(pytree.tree_unflatten(self._carry, self._spec), self._x, noise)
        leaves, self._out_spec = pytree.tree_flatten(out)
        held = {b.untyped_storage().data_ptr() for b in self._carry if torch.is_tensor(b)}
        # an output that is a view of a carry buffer (the staged ring's
        # arriving row) is copied before the buffers are written
        leaves = [v.clone() if v.untyped_storage().data_ptr() in held else v for v in leaves]
        for buf, v in zip(self._carry, pytree.tree_leaves(carry)):
            if torch.is_tensor(buf) and v is not buf:
                buf.copy_(v)
        n = len(leaves)
        self._small = [i for i, v in enumerate(leaves) if v.dtype == _f32 and (v.dim() == 0 or i >= n - self.n_sketch)]
        self._shapes = [tuple(v.shape) for v in leaves]
        big = [v for i, v in enumerate(leaves) if i not in self._small]
        packed = torch.cat([leaves[i].reshape(-1) for i in self._small]) if self._small else None
        return big, packed

    def _capture(self):
        """Warm up eagerly on a side stream, then capture one step.  The
        warm-up's noise comes from a generator of its own, so the run's
        generator is untouched."""
        pm = self.program

        def warm_up():
            key = PRNGKey(0, pm.device, partitionable=self.partitionable) if self.jax_stream else 0
            pm.draw_uniforms(pm.generator(key), self._raw)
            self._body()

        self.graph, self._outs, self.per_replay, self.warmup_s, self.capture_s = capture_step(
            pm.device, warm_up, self._body)

    def _stack(self, big, packed):
        """The ``(T, ...)`` outputs in the step's structure."""
        T, out, bi, col = self.T, [], 0, 0
        for i, shape in enumerate(self._shapes):
            if i in self._small:
                n = int(np.prod(shape))
                out.append(packed[:, col : col + n].reshape(T, *shape).contiguous())
                col += n
            else:
                out.append(big[bi])
                bi += 1
        return pytree.tree_unflatten(out, self._out_spec)

    def __call__(self, carry, gen: NoiseStreams, xs_in):
        leaves, spec = pytree.tree_flatten(carry)
        jax_stream = isinstance(gen, JaxStream)
        partitionable = gen.partitionable if jax_stream else None
        if self.jax_stream is None:
            self.jax_stream, self.partitionable = jax_stream, partitionable
        elif jax_stream != self.jax_stream:
            raise ValueError("a runner keeps the kind of key of its first call (an int seed or a core.prng.Key)")
        elif partitionable != self.partitionable:
            raise ValueError("a runner keeps the threefry mode of its first call's key (partitionable or original)")
        if self._spec is None:
            self._setup(leaves, spec, xs_in)
        elif spec != self._spec or any(
            torch.is_tensor(b) and (b.shape != v.shape or b.dtype != v.dtype) for b, v in zip(self._carry, leaves)
        ):
            raise ValueError("a runner's carry keeps the structure, shapes and dtypes of its first call")
        if self.captured and self.graph is None:
            self._capture()
        for buf, v in zip(self._carry, leaves):
            if torch.is_tensor(buf):
                buf.copy_(v)
        res = packed_res = None
        for t in range(self.T):
            if self._x is not None:
                self._x.copy_(xs_in[t])
            self.program.draw_uniforms(gen, self._raw)
            if self.graph is not None:
                self.graph.replay()
                add_launch_counts(self.per_replay)
                big, packed = self._outs
            else:
                big, packed = self._body()
            if res is None:
                res = [torch.empty((self.T, *v.shape), dtype=v.dtype, device=v.device) for v in big]
                if packed is not None:
                    packed_res = torch.empty((self.T, packed.numel()), dtype=_f32, device=packed.device)
            for r, v in zip(res, big):
                r[t].copy_(v)
            if packed is not None:
                packed_res[t].copy_(packed)
        new = [b.clone() if torch.is_tensor(b) else b for b in self._carry]
        return pytree.tree_unflatten(new, self._spec), self._stack(res, packed_res)

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
takes its noise as tensors (``RoundNoise``: the ``(K,)`` Gumbel row and the
volatility model's uniform rows), and the runner draws them from one
``torch.Generator`` on the device in a fixed order each round: the Gumbel
row, then the model's rows.  The fused and the staged branch consume the
identical row, so they select identically.

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
the same on every rank.  A rank's noise is its own ``(Ks,)`` rows: at D = 1
its generator is seeded as the dense runner's, so a one-rank mesh with
``block=1`` equals the dense ``allocator="bisect"`` runner bit for bit (JAX
skips ``fold_in`` at D = 1 for the same reason); at D > 1 rank ``d`` seeds
from ``numpy.random.SeedSequence([seed, d])``.  As in JAX, ``block`` acts
only under a mesh.  Taps and sketches are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.selection import (
    E3CSState,
    e3cs_probs,
    e3cs_update,
    gumbel_row,
    make_quota_schedule,
    merge_topk_candidates,
    perturbed_scores,
    selection_mask,
)
from repro_torch.core.selection.e3cs import divide, residual_mass
from repro_torch.core.volatility import DEAD_LAG
from repro_torch.device import resolve_device
from repro_torch.engine.sharded import N_ITERS, TILE, _shard_topk_merge, masked_prob_alloc, masked_prob_alloc_scalars
from repro_torch.fl.round import init_server_state, make_select_fn
from repro_torch.kernels.ref import LAG_DEAD_CODE, ring_pop_push
from repro_torch.kernels.round_fused import MAX_S, fused_alloc_select, fused_perturb_select, fused_round_tail
from repro_torch.kernels.unpack_bits import unpack_bits, unpack_crumbs
from repro_torch.obs.trace import stage

__all__ = [
    "RoundProgram",
    "RoundNoise",
    "ring_pop_push",
    "lag_credit_schedule",
    "staleness_ring_step",
    "OBSERVE_MODES",
    "FEEDBACK_MODES",
]

OBSERVE_MODES = ("none", "dense", "packed", "packed_lags")
FEEDBACK_MODES = ("deadline", "late_credit")
_f32 = torch.float32


class RoundNoise(NamedTuple):
    """One round's noise: the Gumbel row for selection and the volatility
    model's uniform rows (empty when outcomes come from a trace)."""

    g: torch.Tensor
    u: Tuple[torch.Tensor, ...] = ()


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

            def select(state, g):
                sigma = quota_fn(state.t)
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
            base = make_select_fn(fl, program.quota_fn)

            def select(state, g):
                idx, p, capped, sigma = base(state, g)
                return idx, p, capped, sigma, selection_mask(idx, K)

        self.select = select
        self.observe = _make_observe(program, K)

    @staticmethod
    def psum(v):
        return v

    @staticmethod
    def pmax(v):
        return v


class _ShardCtx:
    """This rank's stage context under a mesh: the select and observe stages
    on the rank's ``(Ks,)`` slab, and the mesh's collectives."""

    def __init__(self, program: "RoundProgram", Ks: int):
        fl, mesh = program.fl, program.mesh
        K, k, d = fl.K, fl.k, mesh.rank
        active = (torch.arange(d * Ks, (d + 1) * Ks, device=program.device) < K).to(_f32)
        self.active = active
        self.e3cs_kwargs = dict(K=K, mesh=mesh, active=active)
        quota_fn, fused = program.quota_fn, program.fused
        alloc_kw = dict(active=active, n_iters=N_ITERS, tile=TILE, mesh=mesh, block=program.block)
        neg_inf = torch.full((Ks,), float("-inf"), dtype=_f32, device=program.device)

        def select(state, g):
            sigma = quota_fn(state.t)
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
            loc = idx - d * Ks
            valid = ((loc >= 0) & (loc < Ks)).to(_f32)
            mask = torch.zeros(Ks, dtype=_f32, device=g.device).scatter_reduce_(
                0, torch.clamp(loc, 0, Ks - 1).long(), valid, reduce="amax"
            )
            return idx, p, capped, sigma, mask

        self.select = select
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


def _make_step(program: "RoundProgram", ctx, lean: bool):
    """The round body ``step(carry, x_over, noise) -> (carry, out)``: the
    single copy of the round pipeline that ``build_runner`` loops.

    Sync carry is ``(state,)``, async ``(state, rings)`` with ``rings`` the
    ``(credit,)`` or ``(credit, feedback)`` tuple of ``init_rings``.  Outputs
    per round: sync full ``(mask, x, p, sigma)``, sync lean ``(on_time,
    sigma)``, async full ``(mask, lag, p, sigma, arriving)``, async lean
    ``(on_time, stale, sigma)``.  Under a mesh the per-client arrays are the
    rank's slab, and the lean scalars are summed over the ranks.
    """
    fl = program.fl
    k, eta, K = fl.k, fl.eta, fl.K
    sync = program.staleness is None
    S = 0 if sync else int(program.staleness)
    alpha = program.alpha
    late_fb = (not sync) and program.feedback == "late_credit" and S > 0
    fused = program.fused
    if fused:
        decay = tuple(alpha ** (s + 1) for s in range(S))
        kind = {"packed": "bits", "packed_lags": "crumbs"}.get(program.override, "x" if sync else "lag")

    active = ctx.active

    def recentre(logw):
        """Shift to a (masked, global) max of 0; padding stays pinned at 0."""
        if active is None:
            return logw - torch.max(logw)
        m = torch.max(torch.where(active > 0, logw, torch.full_like(logw, float("-inf"))))
        return (logw - ctx.pmax(m)) * active

    def step(carry, x_over, noise: RoundNoise):
        state = carry[0]
        rings = None if sync else carry[1]
        with stage("round.select"):
            idx, p, capped, sigma, mask = ctx.select(state, noise.g)
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
                e3cs = e3cs_update(state.e3cs, p, capped, mask, x, k, sigma, eta, **ctx.e3cs_kwargs)
                loss_cache = torch.where(mask > 0, 1.0 - x, state.loss_cache)
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
                e3cs=e3cs, vol_state=vs, t=state.t + 1, sel_counts=state.sel_counts + mask, loss_cache=loss_cache,
            )
            out = (ctx.psum(torch.dot(mask, x)), sigma) if lean else (mask, x, p, sigma)
            return (state,), out
        on_time = ctx.psum(torch.dot(mask, x))
        stale = ctx.psum(torch.sum(arriving))
        state = state._replace(
            e3cs=e3cs, vol_state=vs, t=state.t + 1, sel_counts=state.sel_counts + mask, loss_cache=loss_cache,
            cep=state.cep + on_time + stale, succ_hist=state.succ_hist + on_time,
        )
        out = (on_time, stale, sigma) if lean else (mask, lag, p, sigma, arriving)
        return (state, new_rings), out

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
        make_select_fn(self.fl, None)  # raises for a scheme or sampler that is not ported
        self.vol = self.vol.to(self.device)
        self.rho = torch.as_tensor(self.rho, dtype=_f32, device=self.device) if self.rho is not None else None
        if self.quota_fn is None:
            fl = self.fl
            self.quota_fn = make_quota_schedule(fl.quota, fl.k, fl.K, fl.rounds, fl.quota_frac, device=self.device)
        self.local_vol = self.vol
        if mesh is not None:
            K_pad, Ks, _, _ = self._sharded_geometry()
            if self.fl.k > Ks:
                raise ValueError(f"k={self.fl.k} exceeds the shard width {Ks}; need k <= K_pad/D for per-shard top-k")
            if self.override == "none":
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
        if self.feedback == "late_credit" and S > 0:
            rings = rings + (torch.zeros(shape, dtype=_f32, device=self.device),)
        return rings

    def generator(self, key) -> torch.Generator:
        """The runner's generator on the device, from an int seed or from a
        state that a ``carry_key`` runner returned.  Rank ``d`` of a mesh of
        D > 1 ranks seeds from ``SeedSequence([seed, d])``."""
        gen = torch.Generator(device=self.device)
        if isinstance(key, torch.Tensor):
            gen.set_state(key)
        elif self.mesh is None or self.mesh.size == 1:
            gen.manual_seed(int(key))
        else:
            gen.manual_seed(int(np.random.SeedSequence([int(key), self.mesh.rank]).generate_state(1, np.uint64)[0]))
        return gen

    def draw_noise(self, gen: torch.Generator) -> RoundNoise:
        """One round's noise in the fixed order: the Gumbel row, then the
        volatility model's rows (only when outcomes come from the model)."""
        g = gumbel_row(gen, self.K_loc, self.device)
        return RoundNoise(g=g, u=self.local_vol.draw(gen) if self.override == "none" else ())

    def _state0(self):
        if self.mesh is None:
            return init_server_state({}, self.fl.K, self.vol.init_state(), self.device)
        K_pad, Ks, _, _ = self._sharded_geometry()
        vs = self.vol.init_state()
        if isinstance(vs, torch.Tensor) and vs.dim() >= 1 and vs.shape[0] == self.fl.K:
            vs = _slab(vs, K_pad, self.mesh.rank, Ks, dim=0)
        return init_server_state({}, Ks, vs, self.device)

    def build_step(self, lean: bool = False, taps: bool = False):
        """The round body ``step(carry, x_over, noise)`` plus its initial
        state (see ``_make_step`` for the carry and outputs); under a mesh,
        this rank's step and slab."""
        if taps:
            raise NotImplementedError("round taps are not ported yet (ROADMAP.md A7)")
        ctx = _LocalCtx(self) if self.mesh is None else _ShardCtx(self, self.K_loc)
        return _make_step(self, ctx, lean), self._state0()

    def build_runner(self, outputs: str = "full", carry_key: bool = False, scan_length: Optional[int] = None,
                     taps: bool = False, sketch=None):
        """The program over a whole horizon; returns ``(run, state0)``.

        * sync  full: ``run(state, key, xs_in=None) -> (state, masks, xs, ps, sigmas)``
        * sync  lean: ``... -> (state, successes, sigmas)``
        * async full: ``... -> (state, masks, lags, ps, sigmas, arrived)``
        * async lean: ``... -> (state, on_time, stale, sigmas)``

        ``key`` is an int seed or a generator state.  ``carry_key=True``
        threads the generator state (and, async, the rings) through so a
        chunked horizon equals a one-shot one: sync ``run(state, key, xs_in)
        -> (state, key, *outs)``, async ``run(state, key, rings, xs_in) ->
        (state, key, rings, *outs)`` (seed rings with ``init_rings``).
        ``xs_in`` holds the ``(T, ...)`` trace rows of the override modes.
        ``scan_length`` runs that many rounds instead of ``fl.rounds``.

        Under a mesh every per-client array in and out (state, rings, trace
        rows, full outputs) is this rank's slab: ``local_rows`` cuts trace
        rows, ``repro_torch.convert`` shards and gathers states.
        """
        if outputs not in ("full", "lean"):
            raise ValueError(f"unknown outputs mode {outputs!r} (want 'full' or 'lean')")
        if taps or sketch is not None:
            raise NotImplementedError("round taps and sketches are not ported yet (ROADMAP.md A7)")
        T = self.fl.rounds if scan_length is None else int(scan_length)
        step, state0 = self.build_step(lean=outputs == "lean")
        sync = self.staleness is None
        replay = self.override != "none"

        def horizon(carry, gen, xs_in):
            if replay and (xs_in is None or len(xs_in) < T):
                raise ValueError(f"override={self.override!r} needs {T} trace rows in xs_in")
            outs = []
            for t in range(T):
                carry, out = step(carry, xs_in[t] if replay else None, self.draw_noise(gen))
                outs.append(out)
            return carry, tuple(torch.stack(col) for col in zip(*outs))

        if sync:

            def run(state, key, xs_in=None):
                gen = self.generator(key)
                (state,), outs = horizon((state,), gen, xs_in)
                return (state, gen.get_state(), *outs) if carry_key else (state, *outs)

        elif carry_key:

            def run(state, key, rings, xs_in=None):
                gen = self.generator(key)
                (state, rings), outs = horizon((state, tuple(r.clone() for r in rings)), gen, xs_in)
                return (state, gen.get_state(), rings, *outs)

        else:

            def run(state, key, xs_in=None):
                gen = self.generator(key)
                (state, _), outs = horizon((state, self.init_rings()), gen, xs_in)
                return (state, *outs)

        return run, state0

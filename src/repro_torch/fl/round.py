"""Server state, the staged allocate + select stage and the FL rounds, the
port of ``repro.fl.round``.

``make_cohort_round`` is the paper's full round: volatile outcomes, the
cohort's local training (``fl.client``, vectorised over the k clients),
masked deadline aggregation and the selector's update;
``make_async_cohort_round`` its staleness-aware form, which returns the
late deltas for the server to apply when they arrive.  Both take any model
of ``models.build_model``: the paper's CNNs and the zoo's LMs (the configs'
``fl_mapping="cohort"``).  ``make_silo_steps`` is the other mapping, for
the huge architectures (``fl_mapping="silo"``): one client trains at a time
and the server accumulates the clients' weighted deltas.

Noise.  Where the JAX package hands ``select`` and ``round_fn`` a key, the
port hands them the round's noise as tensors (``RoundNoise``), drawn by the
caller in the order ``select_draws`` names: E3CS with the Plackett-Luce sampler takes a Gumbel
row, the systematic sampler a permutation and a 0-d uniform, ``random``
and ``pow_d`` a permutation, ``fedcs`` a uniform row, and ``ucb`` nothing;
``round_fn`` takes the volatility model's uniform rows ``u`` (JAX draws them
from ``split(fold_in(rng, 1))[0]``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.selection import (
    E3CSState,
    e3cs_init,
    e3cs_probs,
    e3cs_update,
    fedcs_select,
    gumbel_from_uniform,
    pow_d_select,
    random_select,
    sample_selection,
    selection_mask,
    ucb_init,
    ucb_select,
    ucb_update,
)
from repro_torch.device import resolve_device
from repro_torch.models.cnn import fp32_convs
from repro_torch.obs.trace import stage
from repro_torch.optim import leafwise, sgd

from .aggregation import aggregate, aggregate_async
from .client import make_local_update

__all__ = [
    "ServerState",
    "RoundNoise",
    "SCHEMES",
    "SAMPLERS",
    "init_server_state",
    "make_select_fn",
    "make_cohort_round",
    "make_async_cohort_round",
    "make_silo_steps",
    "select_draws",
    "select_noise",
]

SCHEMES = ("e3cs", "random", "fedcs", "pow_d", "ucb")
SAMPLERS = ("plackett_luce", "systematic")


class ServerState(NamedTuple):
    params: object
    e3cs: E3CSState
    ucb: object  # UCBState
    loss_cache: torch.Tensor  # (K,) pow-d loss estimates
    vol_state: object  # the volatility model's state: a tensor or a tuple of tensors
    t: torch.Tensor  # int32 0-d
    sel_counts: torch.Tensor  # (K,)
    cep: torch.Tensor  # float32 0-d
    succ_hist: torch.Tensor  # float32 0-d successes observed


class RoundNoise(NamedTuple):
    """One round's noise: the selection's (``g`` a Gumbel row, ``perm`` a
    permutation row, ``v`` a uniform row or 0-d uniform; each None where the
    scheme takes none) and the volatility model's uniform rows ``u`` (empty
    when outcomes come from a trace)."""

    g: Optional[torch.Tensor] = None
    u: Tuple[torch.Tensor, ...] = ()
    perm: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None


def init_server_state(params, K: int, vol_state, device=None) -> ServerState:
    """A fresh server state for ``K`` clients on ``device`` (``None``:
    CUDA, which raises without it)."""
    device = resolve_device(device)
    f32 = torch.float32
    return ServerState(
        params=params,
        e3cs=e3cs_init(K, device),
        ucb=ucb_init(K, device),
        loss_cache=torch.full((K,), 1e9, dtype=f32, device=device),  # unexplored => very lossy
        vol_state=vol_state,
        t=torch.zeros((), dtype=torch.int32, device=device),
        sel_counts=torch.zeros(K, dtype=f32, device=device),
        cep=torch.zeros((), dtype=f32, device=device),
        succ_hist=torch.zeros((), dtype=f32, device=device),
    )


def _check(fl_cfg) -> None:
    if fl_cfg.allocator not in ("sort", "bisect"):
        raise ValueError(f"unknown allocator {fl_cfg.allocator!r} (want 'sort' or 'bisect')")
    if fl_cfg.scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {fl_cfg.scheme!r} (want one of {SCHEMES})")
    if fl_cfg.scheme == "e3cs" and fl_cfg.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampling method: {fl_cfg.sampler!r}")
    if fl_cfg.scheme == "pow_d" and fl_cfg.k > fl_cfg.pow_d:
        raise ValueError(f"pow_d selects k={fl_cfg.k} of d={fl_cfg.pow_d} candidates; need k <= d")


def select_draws(fl_cfg, K: int) -> tuple:
    """The raw draws one round's selection takes, in order: ``("rand",
    shape)`` (a ``[0, 1)`` float32 draw) or ``("perm", (n,))`` (a
    permutation of ``n``)."""
    _check(fl_cfg)
    scheme = fl_cfg.scheme
    if scheme == "e3cs":
        return (("rand", (K,)),) if fl_cfg.sampler == "plackett_luce" else (("perm", (K,)), ("rand", ()))
    return {"random": (("perm", (K,)),), "fedcs": (("rand", (K,)),), "pow_d": (("perm", (K,)),), "ucb": ()}[scheme]


def select_noise(fl_cfg, raw) -> dict:
    """The selection's ``RoundNoise`` fields from its raw draws
    (``select_draws``): the Gumbel transform of E3CS's row, the rest as
    drawn."""
    scheme = fl_cfg.scheme
    if scheme == "e3cs":
        if fl_cfg.sampler == "plackett_luce":
            return {"g": gumbel_from_uniform(raw[0])}
        return {"perm": raw[0], "v": raw[1]}
    if scheme in ("random", "pow_d"):
        return {"perm": raw[0]}
    if scheme == "fedcs":
        return {"v": raw[0]}
    return {}


def make_select_fn(fl_cfg, quota_fn, rho=None):
    """``select(state, noise) -> (idx, p, capped, sigma)``: the scheme's
    allocation and cohort from the round's ``RoundNoise``.  E3CS allocates
    by ``fl_cfg.allocator`` (sorted or bisection) and samples by
    ``fl_cfg.sampler``; the baselines report ``p = k/K`` (random) or their
    cohort mask as ``p``.  ``rho`` is FedCS's success-rate hint."""
    _check(fl_cfg)
    K, k, scheme = fl_cfg.K, fl_cfg.k, fl_cfg.scheme
    allocator = fl_cfg.allocator

    def select(state: ServerState, noise: RoundNoise):
        sigma = quota_fn(state.t)
        dev = state.sel_counts.device
        capped = torch.zeros(K, dtype=torch.bool, device=dev)
        if scheme == "e3cs":
            with stage("round.allocate"):
                if allocator == "bisect":
                    from repro_torch.engine.sharded import masked_prob_alloc  # the engine imports this module

                    w = torch.exp(state.e3cs.logw - torch.max(state.e3cs.logw))
                    p, capped = masked_prob_alloc(w, k, sigma)
                else:
                    p, capped = e3cs_probs(state.e3cs, k, sigma)
            with stage("round.sample"):
                idx = sample_selection(noise, p, k, fl_cfg.sampler)
            return idx, p, capped, sigma
        if scheme == "random":
            idx = random_select(noise.perm, K, k)
            return idx, torch.full((K,), k / K, dtype=torch.float32, device=dev), capped, sigma
        if scheme == "fedcs":
            idx = fedcs_select(rho, k, noise.v)
        elif scheme == "ucb":
            idx = ucb_select(state.ucb, k)
        else:
            idx = pow_d_select(noise.perm, state.loss_cache, k, fl_cfg.pow_d)
        return idx, selection_mask(idx, K), capped, sigma

    return select


def _selector_update(state: ServerState, fl_cfg, idx, p, capped, mask, x_full, sigma, local_losses):
    new_e3cs = state.e3cs
    new_ucb = state.ucb
    if fl_cfg.scheme == "e3cs":
        new_e3cs = e3cs_update(state.e3cs, p, capped, mask, x_full, fl_cfg.k, sigma, fl_cfg.eta)
    elif fl_cfg.scheme == "ucb":
        new_ucb = ucb_update(state.ucb, idx, x_full)
    # participating successful clients refresh the pow-d loss cache
    loss_cache = state.loss_cache
    i = idx.long()
    upd = torch.zeros_like(loss_cache).index_put((i,), local_losses.to(loss_cache.dtype))
    got = torch.zeros_like(loss_cache).index_put((i,), x_full[i])
    loss_cache = torch.where(got > 0, upd, loss_cache)
    return new_e3cs, new_ucb, loss_cache


class _DataSplit:
    """The cohort's client axis over the mesh axes ``spmd_axes`` (JAX's
    ``vmap(..., spmd_axis_name=spmd_axes)``): this rank trains the clients
    ``rows`` of the cohort, on parameters replicated over those axes (and
    placed over the mesh's other axes, a ``model`` axis for tensor
    parallelism, by ``models.sharding.distribute_params``)."""

    def __init__(self, params, spmd_axes, k: int):
        from torch.distributed.tensor import DTensor

        leaf = pytree.tree_leaves(params)[0]
        if not isinstance(leaf, DTensor):
            raise ValueError("spmd_axes splits the cohort over a mesh: the parameters must be DTensors "
                             "(models.sharding.distribute_params)")
        mesh = leaf.device_mesh
        names = tuple(mesh.mesh_dim_names)
        axes = (spmd_axes,) if isinstance(spmd_axes, str) else tuple(spmd_axes)
        if any(a not in names for a in axes):
            raise ValueError(f"spmd_axes {axes} are not all axes of the mesh {names}")
        self.mesh, self.k = mesh, k
        self.dims = [names.index(a) for a in axes]
        coord = mesh.get_coordinate()
        D, r = 1, 0
        for j in self.dims:  # the first axis the major, as JAX splits the client axis
            r, D = r * mesh.size(j) + coord[j], D * mesh.size(j)
        if k % D:
            raise ValueError(f"a cohort of k={k} clients does not split over {D} ranks of {axes}")
        self.rows = slice(r * (k // D), (r + 1) * (k // D))
        self.rest = [j for j in range(mesh.ndim) if j not in self.dims]
        tp = any(mesh.size(j) > 1 for j in self.rest)
        self.sub = mesh[tuple(names[j] for j in self.rest)] if tp else None
        self.groups = [mesh.get_group(j) for j in self.dims]

    def local(self, t):
        """A parameter leaf as this rank's clients see it: its local tensor,
        or a DTensor on the mesh's other axes."""
        from torch.distributed.tensor import DTensor

        if any(t.placements[j].is_shard() for j in self.dims):
            raise ValueError(f"a parameter of shape {tuple(t.shape)} is sharded over the cohort's data axes "
                             f"({t.placements}): the cohort mapping replicates parameters there (cohort_rules)")
        loc = t.to_local()
        if self.sub is None:
            return loc
        return DTensor.from_local(loc, self.sub, [t.placements[j] for j in self.rest], run_check=False,
                                  shape=t.shape, stride=t.stride())

    def psum(self, t) -> None:
        """Sum ``t`` over the data axes, in place."""
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor

        loc = t.to_local() if isinstance(t, DTensor) else t
        for g in self.groups:
            dist.all_reduce(loc, op=dist.ReduceOp.SUM, group=g)

    def to_global(self, like, t, lead: int = 0):
        """A local result laid out as the parameter ``like`` (with ``lead``
        more leading axes) as a DTensor on the whole mesh."""
        from torch.distributed.tensor import DTensor, Shard

        from repro_torch.models.sharding import contiguous_strides

        loc = t.to_local() if isinstance(t, DTensor) else t
        pl = [Shard(p.dim + lead) if p.is_shard() else p for p in like.placements]
        shape = (*t.shape[:lead], *like.shape)
        return DTensor.from_local(loc, self.mesh, pl, run_check=False, shape=shape, stride=contiguous_strides(shape))

    def gather_rows(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's ``(k / D,)`` row of a per-client value as the whole
        cohort's ``(k,)`` (zeros elsewhere, summed over the ranks: exact)."""
        from torch.distributed.tensor import DTensor

        v = v.full_tensor() if isinstance(v, DTensor) else v
        full = torch.zeros((self.k,), dtype=v.dtype, device=v.device)
        full[self.rows] = v
        self.psum(full)
        return full


def _plain(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _cohort_round(model, fl_cfg, quota_fn, rho, aggregation, select, observe, merge, spmd_axes=None):
    """The round both factories share: ``observe(u, vol_state) -> (x_full,
    lag_full or None, vol_state)`` and ``merge(state, cohort, success,
    lag_sel, ...)`` are the sync and async halves."""
    opt = sgd(fl_cfg.lr, fl_cfg.momentum)
    local = make_local_update(model, opt, fl_cfg.local_update, fl_cfg.prox_coef)
    per_client = make_local_update(model, opt, fl_cfg.local_update, fl_cfg.prox_coef, per_client=True)
    agg_scheme = aggregation or fl_cfg.aggregation
    select = select if select is not None else make_select_fn(fl_cfg, quota_fn, rho)
    K = fl_cfg.K

    def round_fn(state: ServerState, idx, p, capped, sigma, batches, step_mask, data_sizes, total_data, epochs, u):
        x_full, lag_full, vol_state = observe(u, state.vol_state)  # (K,)
        mask = selection_mask(idx, K)
        i = idx.long()
        success = x_full[i]
        params, train, split, kw = state.params, local, None, {}
        if spmd_axes is not None:
            split = _DataSplit(state.params, spmd_axes, fl_cfg.k)
            params = pytree.tree_map(split.local, state.params)
            batches = {name: b[split.rows] for name, b in batches.items()}
            step_mask = step_mask[split.rows]
            train = per_client if split.sub is not None else local  # vmap does not map DTensors
            kw = {"rows": split.rows, "psum": split.psum}
        with fp32_convs():
            cohort_params, stats = train(params, batches, step_mask)
        if split is not None:  # the aggregation maps each element alone: it runs on the local shards
            params, cohort_params = pytree.tree_map(_plain, params), pytree.tree_map(_plain, cohort_params)
        new_params, extra = merge(params, cohort_params, success, None if lag_full is None else lag_full[i],
                                  data_sizes, total_data, K, agg_scheme, epochs, p[i], **kw)
        local_loss = stats["local_loss"]
        if split is not None:
            new_params = pytree.tree_map(split.to_global, state.params, new_params)
            if "late_deltas" in extra:
                extra["late_deltas"] = pytree.tree_map(lambda g, d: split.to_global(g, d, lead=1), state.params,
                                                       extra["late_deltas"])
            local_loss = split.gather_rows(local_loss)
        new_e3cs, new_ucb, loss_cache = _selector_update(
            state, fl_cfg, idx, p, capped, mask, x_full, sigma, local_loss
        )
        n_succ = torch.sum(success)
        metrics = {
            "cep": state.cep + n_succ,
            "n_success": n_succ,
            **extra.get("metrics", {}),
            "mean_local_loss": torch.mean(local_loss),
            "sigma": sigma,
        }
        new_state = ServerState(
            params=new_params,
            e3cs=new_e3cs,
            ucb=new_ucb,
            loss_cache=loss_cache,
            vol_state=vol_state,
            t=state.t + 1,
            sel_counts=state.sel_counts + mask,
            cep=state.cep + n_succ,
            succ_hist=state.succ_hist + n_succ,
        )
        if "late_deltas" in extra:
            return new_state, metrics, extra["late_deltas"]
        return new_state, metrics

    return select, round_fn


def make_cohort_round(model, fl_cfg, quota_fn, volatility, rho=None, spmd_axes=None, aggregation: Optional[str] = None,
                      select=None):
    """The full round.  Returns ``(select, round_fn)``: ``round_fn(state,
    idx, p, capped, sigma, batches, step_mask, data_sizes, total_data,
    epochs, u) -> (state, metrics)``, ``u`` the volatility model's uniform
    rows; the host calls ``select`` first to gather the cohort's data.
    ``select`` overrides the allocate + select stage (``FLServer`` passes
    ``RoundProgram.select_fn()``); the default builds the same function from
    the config.  ``batches`` hold ``(k, n_steps, B, ...)`` tensors on the
    state's device.

    ``spmd_axes`` (a mesh axis name or a tuple of them) splits the cohort's
    clients over those axes of the parameters' mesh, as JAX's
    ``vmap(spmd_axis_name=...)``: the parameters are DTensors placed by
    ``models.sharding`` (``cohort_rules``, replicated over the data axes),
    every rank gets the whole cohort's batches and trains its ``k / D``
    clients (vectorised, or one after another where the parameters are
    sharded over a ``model`` axis), and the aggregation adds the ranks'
    weighted deltas with an ``all_reduce``.  Selection, volatility and the
    selector's update run alike on every rank from the same noise.  The
    caller runs ``round_fn`` under ``models.sharding.use_rules``."""

    def observe(u, vol_state):
        x_full, vol_state = volatility.sample(u, vol_state)
        return x_full, None, vol_state

    def merge(g, cohort, success, lag_sel, sizes, total, K, scheme, epochs, sel_probs, **kw):
        return aggregate(g, cohort, success, sizes, total, K, scheme, epochs=epochs, sel_probs=sel_probs, **kw), {}

    return _cohort_round(model, fl_cfg, quota_fn, rho, aggregation, select, observe, merge, spmd_axes)


def make_async_cohort_round(model, fl_cfg, quota_fn, lag_model, rho=None, spmd_axes=None,
                            aggregation: Optional[str] = None, select=None):
    """Staleness-aware ``make_cohort_round``: ``lag_model`` draws per-client
    completion lags (int32: 0 on time, ``l >= 1`` late, negative dead);
    ``round_fn`` aggregates the on-time deltas now and returns, third, the
    decayed late contributions (leaves with a leading ``(S,)`` axis, slice
    ``s`` due ``s+1`` rounds later) for the host loop to apply when they
    arrive (``FLServer.run``).  The selector observes the on-time bits
    ``1{lag == 0}``, as the async scan engine does; ``metrics["n_late"]``
    counts the cohort's clients ``1 <= lag <= S``.  ``spmd_axes`` as in
    ``make_cohort_round``."""
    S = int(fl_cfg.staleness_rounds)
    alpha = float(fl_cfg.staleness_alpha)

    def observe(u, vol_state):
        lag_full, vol_state = lag_model.sample(u, vol_state)  # (K,) int32
        return (lag_full == 0).to(torch.float32), lag_full, vol_state  # deadline-based feedback

    def merge(g, cohort, success, lag_sel, sizes, total, K, scheme, epochs, sel_probs, **kw):
        new_params, late = aggregate_async(g, cohort, lag_sel, sizes, total, K, scheme, alpha=alpha, staleness=S,
                                           epochs=epochs, sel_probs=sel_probs, **kw)
        n_late = torch.sum(((lag_sel >= 1) & (lag_sel <= S)).to(torch.float32))
        return new_params, {"late_deltas": late, "metrics": {"n_late": n_late}}

    return _cohort_round(model, fl_cfg, quota_fn, rho, aggregation, select, observe, merge, spmd_axes)


def make_silo_steps(model, fl_cfg):
    """The huge-architecture mapping: one client at a time on the whole
    device.  Returns ``(local_step, opt_init, agg_accum, agg_apply)``:

    * ``local_step(params, opt_state, batch, step) -> (params, opt_state,
      loss)``: one ``sgd(fl_cfg.lr, fl_cfg.momentum)`` step on the loss's
      gradients (plain autograd; the model's layers rematerialise where its
      config says so).  The zoo's losses draw no noise, so no key is taken.
    * ``agg_accum(acc, local, global, w) -> acc``: ``acc + w * (local -
      global)`` leaf by leaf in float32 (``acc`` starts as float32 zeros).
    * ``agg_apply(global, acc) -> new_global``: ``global + acc``, cast back
      to each parameter's dtype.
    """
    opt = sgd(fl_cfg.lr, fl_cfg.momentum)
    f32 = torch.float32

    def local_step(params, opt_state, batch, step):
        leaves, spec = pytree.tree_flatten(params)
        with torch.enable_grad():
            diff = [t.detach().requires_grad_() for t in leaves]
            loss, _ = model.loss(pytree.tree_unflatten(diff, spec), batch)
            grads = torch.autograd.grad(loss, diff)
        params, opt_state = opt.update(params, pytree.tree_unflatten(list(grads), spec), opt_state, step)
        return params, opt_state, loss.detach()

    def agg_accum(acc, local_params, global_params, w):
        return leafwise(lambda a, l, g: a + w * (l.to(f32) - g.to(f32)), acc, local_params, global_params)

    def agg_apply(global_params, acc):
        return leafwise(lambda g, a: (g.to(f32) + a).to(g.dtype), global_params, acc)

    return local_step, opt.init, agg_accum, agg_apply

"""FL server: the deadline-based round loop (paper §III) around the round
step, with evaluation, pow-d candidate loss reporting and history capture
(the port of ``repro.fl.server``).

The loop realises the paper's five stages: (1) client selection and model
distribution (``select`` and the host's data gather), (2) local training,
(3) model transmission, (4) force stop — stages 2-4 collapse into the
success-mask semantics of the round (volatile clients' deltas are masked
out, which *is* the deadline drop) — and (5) aggregation.

With ``staleness_rounds=S > 0`` the rounds are async: late-but-alive
clients' deltas (relative to the global model they were handed) wait in a
pending buffer and are added to the global model when they arrive, decayed
by ``staleness_alpha**lag`` (``aggregate_async``).  The selector still sees
deadline-based feedback.

Noise.  ``FLServer.run`` follows the JAX package's key schedule
(``core.prng``, one key on the device, in the threefry mode of
``PRNGKey``'s default): ``PRNGKey(seed + 1)``, then ``key, k_sel, k_round,
k_cand = split(key, 4)`` every round.  ``k_sel`` draws the selection's noise
as the scheme's ``select`` draws it, ``split(fold_in(k_round, 1))[0]`` the
volatility model's rows (``RoundProgram.draw_noise(vol_path=(2, 1, (0,
2)))``), and ``k_cand`` pow-d's ``permutation(k_cand, K)``.  The second
half of ``fold_in(k_round, 1)`` reaches the reference's local update as its
clients' keys, which no model's loss reads: nothing is drawn for it.  A
test hands ``run`` the JAX package's own draws instead (``noise=``).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from repro_torch.configs.base import FLConfig
from repro_torch.core.prng import Key, PRNGKey, permutation
from repro_torch.core.volatility import make_volatility, paper_success_rates
from repro_torch.device import resolve_device

from .round import ServerState, _DataSplit, init_server_state, make_async_cohort_round, make_cohort_round

__all__ = ["FLServer", "build_volatility"]


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A loss as a plain tensor (a DTensor on a ``model`` axis gathered)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def build_volatility(fl_cfg: FLConfig, K: int, volatility=None, device=None):
    """Resolve the run's volatility spec to ``(vol, rho)`` on ``device``.

    ``volatility`` (or, when omitted, ``fl_cfg.volatility``) is a builtin
    name (``bernoulli | markov | deadline``) built over the paper's class
    rates with the config's stickiness, seed and local epochs; a
    ``repro_torch.scenarios`` name, made at ``(K, fl_cfg.rounds,
    fl_cfg.seed)`` with its own rate hint; or a model object passed through
    (``rho`` from its ``rho``, else its ``marginal_rate()``, else the paper
    classes).  ``device=None`` means CUDA, and raises without it.
    """
    device = resolve_device(device)
    spec = fl_cfg.volatility if volatility is None else volatility
    if not isinstance(spec, str):
        vol = spec.to(device) if hasattr(spec, "to") else spec
        rho = getattr(vol, "rho", None)
        if rho is None and hasattr(vol, "marginal_rate"):
            rho = vol.marginal_rate()
        if rho is None:
            rho = paper_success_rates(K, fl_cfg.success_rates)
        return vol, torch.as_tensor(rho, dtype=torch.float32, device=device)
    if spec in ("bernoulli", "markov", "deadline"):
        vol = make_volatility(
            spec, paper_success_rates(K, fl_cfg.success_rates), stickiness=fl_cfg.markov_stickiness,
            seed=fl_cfg.seed, epochs_choices=fl_cfg.local_epochs, device=device,
        )
        return vol, torch.as_tensor(paper_success_rates(K, fl_cfg.success_rates), device=device)
    from repro_torch.scenarios.registry import make_scenario  # the scenarios import the engine

    try:
        vol, rho = make_scenario(spec, K, fl_cfg.rounds, seed=fl_cfg.seed, device=device)
    except KeyError as e:
        raise ValueError(
            f"unknown volatility {spec!r}: not a builtin (bernoulli | markov | deadline) "
            f"and not a repro_torch.scenarios name ({e})"
        ) from None
    return vol, torch.as_tensor(rho, dtype=torch.float32, device=device)


class FLServer:
    """Runs paper-scale FL (the CNN workloads, cohort mapping) on ``device``
    (``None``: CUDA, which raises without it).

    ``volatility`` overrides ``fl_cfg.volatility`` with a scenario name or a
    model object (see ``build_volatility``); the knobs resolve through one
    path, ``RoundProgram.from_config``, as in the JAX package.
    ``spmd_axes`` splits each round's cohort over those mesh axes
    (``make_cohort_round``); the caller then hands ``init_state`` the
    parameters placed on the mesh and runs ``run`` under
    ``models.sharding.use_rules``.  pow-d's candidates then report their
    losses one after another on every rank, each on the parameters the
    rank's clients train from (their local tensors, or DTensors on the
    mesh's other axes), so the loss cache stays the same on every rank.
    """

    def __init__(self, model, fl_cfg: FLConfig, store, eval_fn=None, spmd_axes=None, volatility=None, device=None):
        from repro_torch.engine.round_program import RoundProgram  # the engine imports fl.round

        self.model = model
        self.spmd_axes = spmd_axes
        self.cfg = fl_cfg
        self.store = store
        self.program = RoundProgram.from_config(fl_cfg, volatility=volatility, device=device)
        self.device = self.program.device
        self.quota = self.program.quota_fn
        self.vol, self.rho = self.program.base_vol, self.program.rho
        self.staleness = 0 if self.program.staleness is None else int(self.program.staleness)
        self.lag_model = self.program.lag_model
        self._select = self.program.select_fn()
        if self.staleness > 0:
            _, self._round = make_async_cohort_round(model, fl_cfg, self.quota, self.lag_model, self.rho, spmd_axes,
                                                     select=self._select)
        else:
            _, self._round = make_cohort_round(model, fl_cfg, self.quota, self.vol, self.rho, spmd_axes,
                                               select=self._select)
        self._eval_fn = eval_fn
        rng = np.random.default_rng(fl_cfg.seed)
        self.epochs = rng.choice(fl_cfg.local_epochs, fl_cfg.K).astype(np.int32)
        # one per-round step budget, so every round has one shape
        spe = max(1, int(max(store.sizes())) // fl_cfg.batch_size)
        self.n_steps = int(max(fl_cfg.local_epochs)) * spe

    def init_state(self, rng=0, params=None) -> ServerState:
        """A fresh server state: ``params``, or the model's initial parameters
        drawn from ``rng``: a ``core.prng.Key`` (the JAX package's
        ``init_state(key)``, its values), or an int seed of a generator on
        the device (the port's Philox stream)."""
        if params is None:
            if not isinstance(rng, Key):
                rng = torch.Generator(device=self.device).manual_seed(int(rng))
            params, _ = self.model.init(rng)
        vol_state = self.lag_model.init_state() if self.lag_model is not None else self.vol.init_state()
        return init_server_state(params, self.cfg.K, vol_state, self.device)

    def _to_device(self, *arrays):
        """Host arrays (the round's numpy batches: images NHWC, labels, the
        step mask) as tensors on the device."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays)

    def _draw(self, stream):
        """One round's ``(RoundNoise, cand)`` from the carried key, which is
        then advanced (``split(key, 4)[0]``)."""
        cand = permutation(stream.round_keys()[3], self.cfg.K) if self.cfg.scheme == "pow_d" else None
        return self.program.draw_noise(stream, vol_path=(2, 1, (0, 2))), cand

    def _report_candidate_losses(self, state: ServerState, perm: torch.Tensor) -> ServerState:
        """pow-d stage: the first d of ``perm`` report their loss on the
        global model, one batch each."""
        cand = perm[: self.cfg.pow_d].cpu().numpy()
        xb, yb, _ = self.store.round_batches(cand, np.ones(self.cfg.K, np.int32), self.cfg.batch_size)
        x, y = self._to_device(xb[:, 0], yb[:, 0])
        batch = {"x": x, "y": y}
        with torch.no_grad():
            if self.spmd_axes is None:
                losses = vmap(lambda b: self.model.loss(state.params, b)[0])(batch)
            else:  # vmap does not map DTensors: each candidate on the parameters this rank's clients see
                split = _DataSplit(state.params, self.spmd_axes, self.cfg.k)
                params = pytree.tree_map(split.local, state.params)
                losses = torch.stack([_whole(self.model.loss(params, {"x": x[i], "y": y[i]})[0])
                                      for i in range(x.shape[0])])
        cache = state.loss_cache.clone()
        cache[torch.from_numpy(cand).to(self.device)] = losses
        return state._replace(loss_cache=cache)

    def run(self, state: ServerState, rounds: Optional[int] = None, eval_every: int = 10,
            noise: Optional[Iterable] = None):
        """``rounds`` rounds from ``state``: ``(state, history)``.  ``noise``,
        when given, yields each round's ``(RoundNoise, cand)`` in place of
        the server's draws (``cand`` pow-d's candidate permutation, else
        None)."""
        cfg = self.cfg
        rounds = rounds or cfg.rounds
        history: Dict[str, List] = {"round": [], "acc": [], "loss": [], "cep": [], "succ_ratio": []}
        draws = iter(noise) if noise is not None else None
        stream = self.program.generator(PRNGKey(cfg.seed + 1, self.device), num=4) if draws is None else None
        dev = self.device
        sizes = self.store.sizes()
        total_q = torch.tensor(float(sizes.sum()), dtype=torch.float32, device=dev)
        pending: Dict[int, List] = {}  # arrival round -> [late deltas]
        n_late_total = 0.0
        for t in range(rounds):
            # async: stale updates scheduled for this round land first
            for delta in pending.pop(t, []):
                state = state._replace(params=pytree.tree_map(lambda g, d: (g.to(torch.float32) + d).to(g.dtype),
                                                              state.params, delta))
            sel_noise, cand = next(draws) if draws is not None else self._draw(stream)
            if cfg.scheme == "pow_d":
                state = self._report_candidate_losses(state, cand)
            idx, p, capped, sigma = self._select(state, sel_noise)
            idx_np = idx.cpu().numpy()
            xb, yb, mask = self.store.round_batches(idx_np, self.epochs, cfg.batch_size, self.n_steps)
            x, y, step_mask = self._to_device(xb, yb, mask)
            q_sel, e_sel = self._to_device(sizes[idx_np], self.epochs[idx_np].astype(np.float32))
            out = self._round(state, idx, p, capped, sigma, {"x": x, "y": y}, step_mask, q_sel, total_q, e_sel,
                              sel_noise.u)
            if self.staleness > 0:
                state, metrics, late_deltas = out
                n_late_total += float(metrics["n_late"])
                for s in range(self.staleness):
                    pending.setdefault(t + s + 1, []).append(pytree.tree_map(lambda a, s=s: a[s], late_deltas))
            else:
                state, metrics = out
            if self._eval_fn is not None and ((t + 1) % eval_every == 0 or t == rounds - 1):
                acc, loss = self._eval_fn(state.params)
                history["round"].append(t + 1)
                history["acc"].append(float(acc))
                history["loss"].append(float(loss))
                history["cep"].append(float(state.cep))
                history["succ_ratio"].append(float(state.cep) / ((t + 1) * cfg.k))
        if self.staleness > 0:
            history["n_late"] = n_late_total
        return state, history

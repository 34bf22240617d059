"""Selector x scenario evaluation grid (the port of
``repro.scenarios.harness``).

Every entry point runs on the JAX package's key stream (``core.prng``): the
same ``seed`` gives the JAX package's rows.  ``run_grid`` runs every
(selector, scenario) cell through the whole-horizon runner
(``engine.scan_sim``, the scenario's model carried in the captured round
step); with ``staleness=S`` each cell also runs the async round on the
same scenario wrapped in ``CompletionLag`` and reports the staleness-aware
CEP.  ``run_grid_multi_job`` maps the scenario axis onto the batched
multi-tenant engine (``engine.multi_job``): one E3CS row a scenario, one
batched step a round.  ``run_replay`` records a scenario once and replays
the frozen trace to each selector, so every selector sees identical bits.
``format_grid`` renders the table.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.fairness import cep, gini, jain_index, selection_entropy, success_ratio, top_share
from repro_torch.core.volatility import CompletionLag
from repro_torch.device import resolve_device
from repro_torch.engine.multi_job import make_multi_job, multi_job_init, pack_jobs
from repro_torch.engine.scan_sim import async_selection_sim, scan_selection_sim

from .registry import make_scenario
from .replay import record_trace

__all__ = ["evaluate_cell", "run_grid", "run_grid_multi_job", "run_replay", "format_grid"]

DEFAULT_SELECTORS = ("e3cs", "random", "fedcs")


def _metrics(masks: np.ndarray, xs: np.ndarray) -> Dict[str, float]:
    masks, xs = torch.from_numpy(np.asarray(masks)), torch.from_numpy(np.asarray(xs))
    counts = masks.sum(0)
    return {
        "cep": float(cep(masks, xs)),
        "eff_participation": float(success_ratio(masks, xs)),
        "jain": float(jain_index(counts)),
        "entropy": float(selection_entropy(counts)),
        "gini": float(gini(counts)),
        "top_decile_share": float(top_share(counts, 0.1)),
    }


def evaluate_cell(
    selector: str, scenario: str, K: int = 100, k: int = 20, T: int = 500,
    seed: int = 0, frac: float = 0.5,
    staleness: Optional[int] = None, alpha: float = 0.5,
    p_late: float = 0.7, lag_decay: float = 0.5,
    feedback: Optional[str] = None,
    device=None,
) -> Dict[str, float]:
    """One (selector, scenario) cell: CEP, effective participation, Jain,
    entropy, Gini and the top decile's share of a sync run.

    With ``staleness=S`` the cell also runs the async round (the scenario
    made again at the same seed, wrapped in ``CompletionLag``) and gains
    ``async_cep`` / ``async_eff``.  With ``feedback="late_credit"`` (needs
    ``staleness``) it also runs the late-credit feedback policy and gains
    ``lc_cep``, ``lc_eff``, ``lc_jain``, ``async_jain`` and ``lc_drift``
    (the largest |difference| of the final E3CS log-weights from deadline
    feedback); both async runs draw identical noise.
    """
    if feedback not in (None, "deadline", "late_credit"):
        raise ValueError(f"unknown feedback policy {feedback!r} (want 'deadline' or 'late_credit')")
    if feedback == "late_credit" and staleness is None:
        raise ValueError("feedback='late_credit' needs staleness=S (the policy lives in the async engine)")
    dev = resolve_device(device)
    vol, rho = make_scenario(scenario, K, T, seed, device=dev)
    out = scan_selection_sim(selector, K=K, k=k, T=T, frac=frac, seed=seed, vol=vol, rho=rho, device=dev)
    row = {"selector": selector, "scenario": scenario, "K": K, "k": k, "T": T}
    row.update(_metrics(out["masks"], out["xs"]))
    if staleness is not None:

        def async_run(fb):
            vol2, _ = make_scenario(scenario, K, T, seed, device=dev)
            lag_model = CompletionLag(vol2, p_late=p_late, lag_decay=lag_decay, max_lag=max(int(staleness), 1))
            return async_selection_sim(
                selector, K=K, k=k, T=T, frac=frac, seed=seed, staleness=int(staleness), alpha=alpha,
                lag_model=lag_model, rho=rho, outputs="lean", feedback=fb, device=dev,
            )

        aout = async_run("deadline")
        row["async_cep"] = aout["cep"]
        row["async_eff"] = aout["cep"] / (T * k)
        if feedback == "late_credit":
            # the policy moves only the E3CS estimator: another selector's
            # late-credit run is its deadline run
            lout = async_run("late_credit") if selector == "e3cs" else aout
            row["async_jain"] = float(jain_index(torch.from_numpy(aout["sel_counts"])))
            row["lc_cep"] = lout["cep"]
            row["lc_eff"] = lout["cep"] / (T * k)
            row["lc_jain"] = float(jain_index(torch.from_numpy(lout["sel_counts"])))
            row["lc_drift"] = float(np.abs(lout["final_logw"] - aout["final_logw"]).max())
    return row


def run_grid(
    selectors: Sequence[str] = DEFAULT_SELECTORS,
    scenarios: Sequence[str] = ("paper_iid", "markov", "diurnal"),
    K: int = 100, k: int = 20, T: int = 500, seed: int = 0, frac: float = 0.5,
    staleness: Optional[int] = 2, alpha: float = 0.5,
    feedback: Optional[str] = None,
    log=None,
    device=None,
) -> List[Dict[str, float]]:
    """The whole grid, one runner per cell (two with ``staleness``, three
    with ``feedback="late_credit"``).  ``log`` is any sink with a
    ``grid_row(row)`` method (``repro_torch.obs``'s ``Reporter`` or
    ``RunLog``): each cell is streamed to it as it finishes."""
    rows = []
    for sc in scenarios:
        for sel in selectors:
            row = evaluate_cell(sel, sc, K=K, k=k, T=T, seed=seed, frac=frac, staleness=staleness, alpha=alpha,
                                feedback=feedback, device=device)
            if log is not None:
                log.grid_row(row)
            rows.append(row)
    return rows


def run_grid_multi_job(scenarios: Sequence[str], K: int = 100, k: int = 20, T: int = 300, seed: int = 0,
                       sigma_frac: float = 0.5, eta: float = 0.5, device=None) -> List[Dict[str, float]]:
    """E3CS against every scenario in one batched engine: job j is scenario
    j.  Each round ``t`` every scenario's model draws its ``(K,)`` success
    bits under ``fold_in(vol_keys[j], t)`` (the models' states differ, so
    they step one by one), the rows are stacked, and one batched step
    advances all J selectors, job ``j``'s Gumbel row under
    ``fold_in(base_keys[j], t)`` (one launch for the J rows); ``base_keys``
    and ``vol_keys`` are ``split(PRNGKey(seed), J)`` and ``split(PRNGKey(seed
    + 1), J)``, as in the JAX package."""
    dev = resolve_device(device)
    J = len(scenarios)
    cfg, k_max = pack_jobs([K] * J, [k] * J, [sigma_frac] * J, [eta] * J, device=dev)
    _, batched = make_multi_job(k_max)
    state = multi_job_init(cfg)
    vols = [make_scenario(sc, K, T, seed, device=dev)[0] for sc in scenarios]
    vol_states = [v.init_state() for v in vols]
    base_keys = prng.split_data(prng.PRNGKey(seed, dev), J)
    vol_keys = prng.split(prng.PRNGKey(seed + 1, dev), J)
    ceps = torch.zeros(J, dtype=torch.float32, device=dev)
    counts = torch.zeros((J, K), dtype=torch.float32, device=dev)
    for t in range(T):
        xs_rows = []
        for j, vol in enumerate(vols):
            x, vol_states[j] = vol.sample(vol.draw(prng.fold_in(vol_keys[j], t)), vol_states[j])
            xs_rows.append(x)
        xs = torch.stack(xs_rows)
        state, out = batched(cfg, state, prng.rows(base_keys, (t,), K), xs)
        ceps += (out["mask"] * xs).sum(1)
        counts += out["mask"]
    rows = []
    for j, sc in enumerate(scenarios):
        cep_j = float(ceps[j])
        rows.append({
            "selector": "e3cs(multi_job)",
            "scenario": sc,
            "K": K, "k": k, "T": T,
            "cep": cep_j,
            "eff_participation": cep_j / (T * k),
            "jain": float(jain_index(counts[j])),
            "entropy": float(selection_entropy(counts[j])),
        })
    return rows


def run_replay(
    selector, scenario: str, K: int = 100, k: int = 20, T: int = 500,
    seed: int = 0, frac: float = 0.5, chunk: int = 256, pow_d: int = 40,
    device=None,
):
    """Record the scenario once (bit-packed), then run each selector on the
    frozen trace: every selector sees identical bits.  ``selector`` is one
    scheme name (returns ``(row, packed)``) or a sequence of them (returns
    ``(rows, packed)``); ``pow_d`` is power-of-choice's candidate-set size.

    Both the recording and the selectors run from ``PRNGKey(seed)``, as in
    the JAX package, and so share its keys: round ``t``'s recorded rows
    come from ``fold_in(key_t, 1)``, and so does an E3CS selector's Gumbel
    row (``split(key, 3)[1]``), where ``key_t`` is the key both carry
    after ``t`` rounds (``fold_in(., 0)`` a round in both).  The reference
    correlates the two this way, and the port copies it."""
    single = isinstance(selector, str)
    selectors = (selector,) if single else tuple(selector)
    dev = resolve_device(device)
    vol, rho = make_scenario(scenario, K, T, seed, device=dev)
    packed = record_trace(vol, T, seed=seed, chunk=min(chunk, T), device=dev)
    rows = []
    for sel in selectors:
        out = scan_selection_sim(sel, K=K, k=k, T=T, frac=frac, seed=seed, rho=rho, packed_override=packed,
                                 pow_d=pow_d, device=dev)
        row = {"selector": sel, "scenario": f"{scenario}(replay)", "K": K, "k": k, "T": T}
        row.update(_metrics(out["masks"], out["xs"]))
        rows.append(row)
    return (rows[0] if single else rows), packed


def format_grid(rows: List[Dict[str, float]]) -> str:
    """Fixed-width table: scenarios x selectors with the metrics (plus the
    async columns when the grid ran with ``staleness``, and the late-credit
    columns when it ran with ``feedback="late_credit"``)."""
    has_async = any("async_cep" in r for r in rows)
    has_lc = any("lc_cep" in r for r in rows)
    hdr = (
        f"{'scenario':<22} {'selector':<16} {'cep':>9} {'eff_part':>9} {'jain':>6} "
        f"{'gini':>6} {'top10%':>6} {'entropy':>8}"
    )
    if has_async:
        hdr += f" {'acep':>9} {'aeff':>7}"
    if has_lc:
        hdr += f" {'a_jain':>7} {'lc_cep':>9} {'lc_eff':>7} {'lc_jain':>7} {'lc_drift':>9}"
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        line = (
            f"{r['scenario']:<22} {r['selector']:<16} {r['cep']:>9.0f} "
            f"{r['eff_participation']:>9.3f} {r['jain']:>6.3f} "
            f"{r.get('gini', float('nan')):>6.3f} {r.get('top_decile_share', float('nan')):>6.3f} "
            f"{r['entropy']:>8.3f}"
        )
        if has_async:
            if "async_cep" in r:
                line += f" {r['async_cep']:>9.0f} {r['async_eff']:>7.3f}"
            else:
                line += f" {'-':>9} {'-':>7}"
        if has_lc:
            if "lc_cep" in r:
                line += (
                    f" {r['async_jain']:>7.3f} {r['lc_cep']:>9.0f} {r['lc_eff']:>7.3f}"
                    f" {r['lc_jain']:>7.3f} {r['lc_drift']:>9.2e}"
                )
            else:
                line += f" {'-':>7} {'-':>9} {'-':>7} {'-':>7} {'-':>9}"
        lines.append(line)
    return "\n".join(lines)

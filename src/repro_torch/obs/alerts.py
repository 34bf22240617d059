"""Rule-based alert detection over tap and sketch streams (the port of
``repro.obs.alerts``, numpy only).

A detector pass turns the taps (what happened per round) and the sketches
(to whom) into a short list of "something needs a look" events appended to
the JSONL run log (schema v2 ``alert`` records).  Four rule families, all
deterministic host-side numpy over series the runners already emit:

* **outage**: the windowed mean of per-round on-time credit collapses below
  a fraction of the best prior window.
* **starvation**: Jain below ``jain_min``, or the most-selected decile of
  clients holding more than ``top_share_max`` of all selection mass.
* **engine_restart**: the serving supervisor's ``restarts`` gauge (the
  ``serve`` tap group) is nonzero.
* **drift**: the cohort size leaves the configured k (``selected`` must
  equal k every round), or the fraction of probability-capped clients
  sustains above ``cap_frac_max``.

``detect_alerts`` returns ``Alert`` records; ``log_alerts`` appends them to
a ``RunLog``; ``report.Reporter.alerts`` wires both into a run's emission
path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Alert", "AlertRules", "detect_alerts", "log_alerts", "SEVERITIES"]

SEVERITIES = ("warn", "critical")


@dataclasses.dataclass(frozen=True)
class Alert:
    """One detector firing: rule name, severity, locating detail."""

    rule: str
    severity: str
    detail: dict
    message: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r} (want one of {SEVERITIES})")


@dataclasses.dataclass(frozen=True)
class AlertRules:
    """Thresholds for the detector pass (defaults sized for the paper's
    regimes: a halved window of credit is an outage, Jain below 0.4 or a
    decile hoarding 60% of selections is starvation)."""

    outage_drop: float = 0.5  # window mean on_time below this fraction of best prior window
    jain_min: float = 0.4
    top_share_max: float = 0.6
    cap_frac_max: float = 0.5
    window: int = 0  # rounds per detector window; 0 = T // 10 (min 1)


def _window_means(s: np.ndarray, window: int) -> np.ndarray:
    n = s.shape[0] // window
    return s[: n * window].reshape(n, window).mean(axis=1) if n else np.zeros((0,))


def detect_alerts(
    series: Optional[Dict[str, np.ndarray]] = None,
    fairness: Optional[Dict[str, np.ndarray]] = None,
    expected_selected: Optional[float] = None,
    rules: AlertRules = AlertRules(),
) -> List[Alert]:
    """Run the detector pass.

    ``series`` is a per-round tap series dict (``{"on_time": (T,), ...}``,
    any subset); ``fairness`` a sketch-cadence fairness dict
    (``sketches.fairness_series`` output, any subset); ``expected_selected``
    the configured cohort size k.  Missing inputs skip their rules — the
    pass degrades gracefully to whatever telemetry a runner produced.
    """
    alerts: List[Alert] = []
    series = {k: np.asarray(v, np.float64).reshape(-1) for k, v in (series or {}).items()}
    fairness = {k: np.asarray(v, np.float64).reshape(-1) for k, v in (fairness or {}).items()}

    # --- outage: windowed on-time credit collapse -----------------------
    on_time = series.get("on_time")
    if on_time is not None and on_time.size:
        W = rules.window or max(1, on_time.shape[0] // 10)
        means = _window_means(on_time, W)
        best = -np.inf
        for w, m in enumerate(means):
            if w and best > 0 and m < rules.outage_drop * best:
                alerts.append(Alert(
                    "outage", "critical",
                    {"window": int(w), "rounds_per_window": int(W),
                     "on_time_mean": float(m), "prior_best": float(best)},
                    f"on-time credit fell to {m:.2f}/round in window {w} "
                    f"(best prior window {best:.2f})",
                ))
                break  # one firing per run is enough to flag it
            best = max(best, float(m))

    # --- starvation: fairness series past thresholds --------------------
    jain = fairness.get("jain")
    if jain is not None and jain.size and float(jain[-1]) < rules.jain_min:
        alerts.append(Alert(
            "starvation", "warn",
            {"jain": float(jain[-1]), "jain_min": rules.jain_min,
             "emission": int(jain.shape[0] - 1)},
            f"Jain index {jain[-1]:.3f} below floor {rules.jain_min}",
        ))
    top = fairness.get("top_decile_share")
    if top is not None and top.size and float(top[-1]) > rules.top_share_max:
        alerts.append(Alert(
            "starvation", "warn",
            {"top_decile_share": float(top[-1]), "top_share_max": rules.top_share_max,
             "emission": int(top.shape[0] - 1)},
            f"top decile of clients holds {top[-1]:.1%} of selection mass "
            f"(cap {rules.top_share_max:.0%})",
        ))

    # --- drift: engine invariants moving --------------------------------
    selected = series.get("selected")
    if selected is not None and selected.size and expected_selected is not None:
        off = np.flatnonzero(selected != float(expected_selected))
        if off.size:
            alerts.append(Alert(
                "drift", "critical",
                {"metric": "selected", "expected": float(expected_selected),
                 "rounds_off": int(off.size), "first_round": int(off[0]),
                 "value": float(selected[off[0]])},
                f"cohort size left k={expected_selected} in {off.size} rounds "
                f"(first at round {int(off[0])})",
            ))
    # --- engine_restart: the serving supervisor had to recover ----------
    restarts = series.get("restarts")
    if restarts is not None and restarts.size:
        n = float(restarts.sum())
        if n > 0:
            recovery = series.get("recovery_s")
            alerts.append(Alert(
                "engine_restart", "warn",
                {"restarts": n,
                 "recovery_s": float(recovery.sum()) if recovery is not None else 0.0,
                 "first_dispatch": int(np.flatnonzero(restarts)[0])},
                f"{n:.0f} supervised engine restart(s) during the run",
            ))

    capped = series.get("capped_frac")
    if capped is not None and capped.size:
        W = rules.window or max(1, capped.shape[0] // 10)
        means = _window_means(capped, W)
        if means.size and float(means[-1]) > rules.cap_frac_max:
            alerts.append(Alert(
                "drift", "warn",
                {"metric": "capped_frac", "window_mean": float(means[-1]),
                 "cap_frac_max": rules.cap_frac_max, "window": int(means.shape[0] - 1)},
                f"{means[-1]:.1%} of clients at the probability cap "
                f"(threshold {rules.cap_frac_max:.0%})",
            ))
    return alerts


def log_alerts(log, alerts: List[Alert]) -> List[dict]:
    """Append ``Alert`` records to a ``RunLog`` (schema v2 ``alert`` events)."""
    return [log.alert(a.rule, a.severity, a.detail, a.message) for a in alerts]

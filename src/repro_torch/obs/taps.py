"""Round taps: a typed registry of counters and gauges carried with the
round program's state (the port of ``repro.obs.taps``).

A *tap* observes values the round body already computes (cohort mask,
credited successes, quota floor) and turns them into a uniform telemetry
schema without host callbacks and without touching the round's math or its
noise: a taps-on horizon's state equals the taps-off one bit for bit.

Three kinds:

* **gauge**: a per-round scalar, one row of the round's outputs.  Under a
  mesh the round's gauges are summed over the ranks inside the step (one
  ``all_reduce`` of the stacked gauges), so every placement emits the same
  value on every rank.
* **counter**: a running sum carried with the state (``init_counters``
  builds the dict of 0-d float32 tensors); lands once in the run summary.
* **hist**: a bucketed host-side histogram (``repro_torch.obs.trace``):
  latency quantiles for serving loops.  Hist taps never enter the round.

Per-round gauge series are reduced into **step-windowed aggregates**
(``window_reduce``: p50 / p99 / mean / sum per window of W rounds), the
shape the JSONL run logs and ``BENCH_*.json`` ``metrics`` streams carry.

``ROUND_TAPS`` is the registry the ``RoundProgram`` taps stage emits; every
placement (local, ``mesh=D``, async ``S>0``) produces the same schema, the
JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["TapSpec", "TapRegistry", "ROUND_TAPS", "window_reduce", "WINDOW_AGGS"]

KINDS = ("counter", "gauge", "hist")
# gate directions check_bench understands; "none" = report, never gate
DIRECTIONS = ("higher", "lower", "equal", "none")
WINDOW_AGGS = ("p50", "p99", "mean", "sum")


@dataclasses.dataclass(frozen=True)
class TapSpec:
    """One typed metric: its name, kind, gate direction and provenance.

    ``group`` partitions a registry into independent row schemas: the
    ``"round"`` group is the gauge row the round step emits every round;
    the ``"fairness"`` group names the client-axis series derived host-side
    from the sketch stream (``sketches.fairness_series``); the ``"serve"``
    group is the per-dispatch row a serving transport samples: the same
    windowing, run-log and gating machinery, different producers.
    """

    name: str
    kind: str
    doc: str = ""
    better: str = "none"  # how check_bench should gate the windowed p50
    source: Tuple[str, ...] = ()  # counters: gauge row keys summed per round ((), = +1/round)
    group: str = "round"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown tap kind {self.kind!r} (want one of {KINDS})")
        if self.better not in DIRECTIONS:
            raise ValueError(f"unknown gate direction {self.better!r} (want one of {DIRECTIONS})")
        if self.source and self.kind != "counter":
            raise ValueError(f"tap {self.name!r}: only counters accumulate a source")


class TapRegistry:
    """An ordered, name-unique set of ``TapSpec`` — the schema one taps
    stage emits."""

    def __init__(self, *specs: TapSpec):
        self.specs: Dict[str, TapSpec] = {}
        for s in specs:
            if s.name in self.specs:
                raise ValueError(f"duplicate tap {s.name!r}")
            self.specs[s.name] = s
        for s in self.counters():
            for src in s.source:
                if src not in self.specs or self.specs[src].kind != "gauge":
                    raise ValueError(f"counter {s.name!r} accumulates unknown gauge {src!r}")

    def __iter__(self):
        return iter(self.specs.values())

    def __contains__(self, name: str) -> bool:
        return name in self.specs

    def gauges(self, group: Optional[str] = None) -> Sequence[TapSpec]:
        """Gauge specs, optionally restricted to one ``group`` (None = all)."""
        return [s for s in self.specs.values() if s.kind == "gauge" and group in (None, s.group)]

    def counters(self) -> Sequence[TapSpec]:
        """Counter specs — monotone accumulators over their source gauges."""
        return [s for s in self.specs.values() if s.kind == "counter"]

    def gauge_names(self, group: Optional[str] = "round") -> Tuple[str, ...]:
        """Gauge names of one group (default: the ``"round"`` row schema,
        what the round step's tap stage emits); ``group=None`` = all."""
        return tuple(s.name for s in self.gauges(group))

    def directions(self, group: Optional[str] = None) -> Dict[str, str]:
        """Gate-direction map for the windowed gauge streams (all groups by
        default — extra keys are harmless to consumers of one stream)."""
        return {s.name: s.better for s in self.gauges(group)}

    def init_counters(self, device=None):
        """Zeroed counters for the round's carry: 0-d float32 tensors on
        ``device`` (``None``: CUDA, which raises without it)."""
        import torch

        from repro_torch.device import resolve_device

        device = resolve_device(device)
        return {s.name: torch.zeros((), dtype=torch.float32, device=device) for s in self.counters()}

    def accumulate(self, counters, row):
        """One counter update from this round's gauge row."""
        out = {}
        for s in self.counters():
            inc = sum((row[f] for f in s.source), 0.0) if s.source else 1.0
            out[s.name] = counters[s.name] + inc
        return out

    def validate_row(self, row: dict, group: Optional[str] = "round"):
        """The schema contract: a tap row is exactly one group's gauge set."""
        want = set(self.gauge_names(group))
        got = set(row)
        if want != got:
            raise ValueError(f"tap row schema mismatch: missing {sorted(want - got)}, extra {sorted(got - want)}")


ROUND_TAPS = TapRegistry(
    TapSpec("selected", "gauge", "clients in this round's cohort", better="equal"),
    TapSpec("on_time", "gauge", "successes credited at the deadline (Eq. 8 numerator)", better="higher"),
    TapSpec("stale", "gauge", "decayed alpha**lag late credit arriving this round"),
    TapSpec("sigma", "gauge", "fairness quota floor in force this round"),
    TapSpec("capped_frac", "gauge", "fraction of the population at the ProbAlloc p<=1 cap"),
    TapSpec("rounds", "counter", "rounds executed"),
    TapSpec("cum_selected", "counter", "cumulative cohort slots issued", source=("selected",)),
    TapSpec("cum_credit", "counter", "running staleness-aware CEP", source=("on_time", "stale")),
    # client-axis fairness series, derived host-side from the sketch stream
    # (sketches.fairness_series) at the sketch cadence
    TapSpec("jain", "gauge", "exact Jain index of cumulative selection counts",
            better="higher", group="fairness"),
    TapSpec("gini", "gauge", "grouped-data Gini of cumulative selection counts",
            better="lower", group="fairness"),
    TapSpec("top_decile_share", "gauge", "selection-mass share of the most-selected 10% of clients",
            better="lower", group="fairness"),
    TapSpec("region_cep_skew", "gauge", "max per-region on-time credit rate over the fleet average",
            group="fairness"),
    # serving-loop gauges, sampled host-side per batched dispatch by a
    # serving transport: one row per server tick
    TapSpec("queue_depth", "gauge", "tick requests waiting in the admission queue",
            group="serve"),
    TapSpec("batch_jobs", "gauge", "tenant jobs coalesced into this dispatch",
            group="serve"),
    TapSpec("shed", "gauge", "requests shed this tick (queue at capacity)",
            better="lower", group="serve"),
    TapSpec("restarts", "gauge", "supervised engine restarts landed since the last dispatch",
            better="lower", group="serve"),
    TapSpec("recovery_s", "gauge", "seconds spent in crash recovery since the last dispatch",
            better="lower", group="serve"),
)


def window_reduce(series: Dict[str, np.ndarray], window: int, aggs: Sequence[str] = WINDOW_AGGS) -> dict:
    """Reduce per-round series into step-windowed aggregates.

    ``series`` maps metric name -> (T,) array; rounds are grouped into
    ``T // window`` full windows of ``window`` rounds (a trailing partial
    window is dropped and reported as ``dropped`` — windows stay comparable
    across runs).  Returns::

        {"window": W, "n_windows": n, "dropped": d,
         "aggs": {name: {"p50": [...], "p99": [...], "mean": [...], "sum": [...]}}}

    Percentiles use numpy's default linear interpolation, so values are
    hand-checkable.
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out: dict = {"window": int(window), "aggs": {}}
    n_windows: Optional[int] = None
    for name, s in series.items():
        s = np.asarray(s, np.float64).reshape(-1)
        n = s.shape[0] // window
        if n_windows is None:
            n_windows, dropped = n, s.shape[0] - n * window
            out["n_windows"], out["dropped"] = int(n_windows), int(dropped)
        elif n != n_windows:
            raise ValueError(f"series {name!r} has {n} windows, expected {n_windows}")
        w = s[: n * window].reshape(n, window)
        cell = {}
        for agg in aggs:
            if agg == "p50":
                cell[agg] = np.percentile(w, 50, axis=1).tolist() if n else []
            elif agg == "p99":
                cell[agg] = np.percentile(w, 99, axis=1).tolist() if n else []
            elif agg == "mean":
                cell[agg] = w.mean(axis=1).tolist() if n else []
            elif agg == "sum":
                cell[agg] = w.sum(axis=1).tolist() if n else []
            else:
                raise ValueError(f"unknown aggregate {agg!r} (want a subset of {WINDOW_AGGS})")
        out["aggs"][name] = cell
    if n_windows is None:
        out["n_windows"], out["dropped"] = 0, 0
    return out

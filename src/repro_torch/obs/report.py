"""The unified reporter: one emission path for every runner (the port of
``repro.obs.report``).

A ``Reporter`` owns a run's outward-facing artifacts:

* the ``name,us_per_call,derived`` CSV rows on stdout,
* ``BENCH_<name>.json`` under the bench dir, with an optional ``"metrics"``
  block of windowed streams,
* a paired JSONL run log (``runlog.RunLog``) carrying the same streams as
  structured events.

Runners attach windowed metric streams with ``metrics_stream`` (handing it
the per-round series of a taps-enabled run), the client-axis fairness series
with ``fairness_stream`` and the detector pass with ``alerts``; serving
loops attach latency histograms with ``histogram``.  ``save`` writes the
bench JSON with everything accumulated so far; the run log is written
incrementally.  The files land under ``paths.bench_dir()`` and
``paths.runlog_dir()``, the port's own directories of the results tree.

The ``"metrics"`` block in bench JSON looks like::

    "metrics": {
      "<stream>": {
        "window": W, "n_windows": n, "dropped": d,
        "better": {"on_time": "higher", ...},
        "aggs": {"on_time": {"p50": [...], "p99": [...], ...}, ...}
      }
    }
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .alerts import AlertRules, detect_alerts, log_alerts
from .paths import bench_path
from .runlog import RunLog, _jsonable
from .sketches import fairness_series
from .taps import ROUND_TAPS, window_reduce

__all__ = ["Reporter"]


class Reporter:
    """One run's emission surface: CSV rows + bench JSON + JSONL run log.

    ``Reporter("serve_sharded", config={...})`` opens the paired run log
    eagerly; pass ``runlog=False`` for pure-JSON writers (e.g. table
    harvesters) that should not produce an event stream.  Reruns under the
    same name never truncate an earlier log: the run log is opened with
    ``unique=True`` (numbered sibling paths, stable ``run`` header name).
    """

    def __init__(self, name: str, config: Optional[dict] = None, runlog: bool = True):
        self.name = name
        self.data: dict = {}
        self.metrics: Dict[str, dict] = {}
        self.log: Optional[RunLog] = RunLog(name, config=config, unique=True) if runlog else None

    # -- stdout CSV (harness convention, unchanged) -----------------------
    def emit(self, name: str, us_per_call: float, derived: str = ""):
        """One ``name,us,derived`` CSV line on stdout (the harness format)."""
        print(f"{name},{us_per_call:.1f},{derived}", flush=True)

    # -- structured streams ----------------------------------------------
    def update(self, **data) -> "Reporter":
        """Merge scalar results into the bench JSON payload."""
        self.data.update(data)
        return self

    def metrics_stream(
        self,
        stream: str,
        series: Dict[str, np.ndarray],
        window: int,
        better: Optional[Dict[str, str]] = None,
    ) -> dict:
        """Window-reduce per-round series and attach them as a named stream
        (bench JSON ``metrics`` block + a ``metrics`` run-log event)."""
        windows = window_reduce(series, window)
        block = dict(windows)
        block["better"] = dict(better or {})
        self.metrics[stream] = block
        if self.log is not None:
            self.log.metrics(stream, windows, better=better)
        return block

    def fairness_stream(self, stream: str, sketches) -> Dict[str, np.ndarray]:
        """Derive the client-axis fairness series from a runner's
        ``"sketches"`` payload and attach them as a metrics stream (window=1:
        the sketch cadence already windows the rounds).  Directions come
        from the ``fairness`` tap group, so ``check_bench`` gates the
        stream like any other."""
        series = fairness_series(sketches)
        self.metrics_stream(stream, series, window=1, better=ROUND_TAPS.directions("fairness"))
        return series

    def alerts(
        self,
        series: Optional[Dict[str, np.ndarray]] = None,
        fairness: Optional[Dict[str, np.ndarray]] = None,
        expected_selected: Optional[float] = None,
        rules: AlertRules = AlertRules(),
    ) -> list:
        """Run the rule-based detector pass (``alerts``) over tap
        + fairness series; append ``alert`` events to the run log and an
        ``alerts`` list to the bench JSON.  Returns the ``Alert`` list."""
        found = detect_alerts(series, fairness, expected_selected, rules)
        self.data["alerts"] = [
            {"rule": a.rule, "severity": a.severity, "message": a.message, **a.detail}
            for a in found
        ]
        if self.log is not None:
            log_alerts(self.log, found)
        return found

    def histogram(self, name: str, hist) -> dict:
        """Attach a latency histogram: summary into bench JSON under
        ``hists.<name>``, full buckets into the run log."""
        summary = hist.summary() if hasattr(hist, "summary") else dict(hist)
        self.data.setdefault("hists", {})[name] = summary
        if self.log is not None:
            self.log.histogram(name, hist)
        return summary

    def grid_row(self, row: dict) -> dict:
        """Forward one evaluation-grid row to the run log (no-op without one)."""
        if self.log is not None:
            self.log.grid_row(row)
        return row

    # -- persistence -------------------------------------------------------
    def save(self, obj: Optional[dict] = None, summary: bool = True) -> str:
        """Write ``BENCH_<name>.json`` (merging ``obj`` if given) and close
        the run log with a summary event."""
        import json

        if obj:
            self.data.update(obj)
        payload = dict(_jsonable(self.data))
        if self.metrics:
            payload["metrics"] = _jsonable(self.metrics)
        path = bench_path(self.name)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=float)
        if self.log is not None:
            if summary:
                self.log.summary(**{k: v for k, v in payload.items() if not isinstance(v, (dict, list))})
            self.log.close()
        return path

    def close(self) -> None:
        """Close the run log without writing the bench JSON (see ``save``)."""
        if self.log is not None:
            self.log.close()

    def __enter__(self) -> "Reporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

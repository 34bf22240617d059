"""The metrics spine of the port (``repro.obs``'s layout and exports).

* ``taps``: the round's typed gauges and counters and ``window_reduce``.
* ``sketches``: fixed-size mergeable client-axis sketches and the fairness
  series derived from them.
* ``alerts``: rule-based outage/starvation/drift detection.
* ``runlog``: schema-versioned JSONL run logs; ``report``: the ``Reporter``
  a run emits through; ``paths``: the results layout.
* ``trace``: stage annotations and host-side latency histograms.

The host-side modules are numpy only; the tensor code of the taps and
sketches imports ``torch`` where it runs.
"""
from .alerts import Alert, AlertRules, detect_alerts, log_alerts
from .paths import (
    artifact_path,
    autotune_dir,
    autotune_path,
    bench_dir,
    bench_path,
    results_root,
    runlog_dir,
    runlog_path,
)
from .report import Reporter
from .runlog import SCHEMA_VERSION, RunLog, iter_alerts, iter_metrics, read_runlog, validate_records
from .sketches import SKETCH_FIELDS, SketchSpec, fairness_series, merge_sketches, sketch_from_dense
from .taps import ROUND_TAPS, TapRegistry, TapSpec, window_reduce
from .trace import LatencyHistogram, SpanTimer, stage

__all__ = [
    "artifact_path", "bench_dir", "bench_path", "results_root", "runlog_dir", "runlog_path",
    "autotune_dir", "autotune_path",
    "Reporter",
    "SCHEMA_VERSION", "RunLog", "read_runlog", "validate_records", "iter_metrics", "iter_alerts",
    "SKETCH_FIELDS", "SketchSpec", "fairness_series", "merge_sketches", "sketch_from_dense",
    "Alert", "AlertRules", "detect_alerts", "log_alerts",
    "ROUND_TAPS", "TapRegistry", "TapSpec", "window_reduce",
    "LatencyHistogram", "SpanTimer", "stage",
]

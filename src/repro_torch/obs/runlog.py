"""Schema-versioned JSONL run logs (the port of ``repro.obs.runlog``, the
same schema: a log either package writes validates under the other).

A run log is a sequence of JSON objects, one per line.  Every record
carries ``{"schema": SCHEMA_VERSION, "event": <type>, "run": <run id>,
"ts": <unix seconds>}`` plus the event payload.  Event types:

``header``     run identity: name, config dict, emitted first.
``metrics``    one windowed metric stream (``taps.window_reduce`` output
               plus the gate-direction map) under a stream name.
``grid_row``   one (selector, scenario) row of an evaluation grid.
``histogram``  a bucketed latency histogram (``trace.LatencyHistogram``).
``alert``      one rule-based detector firing (``alerts``): rule name,
               severity, and a detail dict locating the offending
               window/values.  Schema v2 only.
``summary``    final scalars (counters, throughput); emitted last.

Schema history: **v1** had no ``ts`` and no ``alert`` event; **v2** (current)
adds both.  The reader side (``read_runlog`` / ``validate_records``) accepts
v1 records unchanged, while the writer always emits v2.

``RunLog`` refuses to clobber an existing log (``FileExistsError``) unless
``overwrite=True``; ``unique=True`` instead picks the first free numbered
path (``<run>.jsonl``, ``<run>.2.jsonl``, ...) while keeping the ``run``
header name stable.  Writers fail loudly on a missing filesystem target:
telemetry silently dropped is worse than a crash.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, Iterator, List, Optional

from .paths import runlog_path

__all__ = [
    "SCHEMA_VERSION",
    "SUPPORTED_SCHEMAS",
    "RunLog",
    "read_runlog",
    "validate_records",
    "iter_metrics",
    "iter_alerts",
    "EVENT_TYPES",
]

SCHEMA_VERSION = 2
SUPPORTED_SCHEMAS = (1, 2)
EVENT_TYPES = ("header", "metrics", "grid_row", "histogram", "alert", "summary")
# event types that did not exist at v1 (a v1 record carrying one is invalid)
_V2_EVENTS = ("alert",)
# payload keys required per event type (beyond the envelope)
_REQUIRED: Dict[str, tuple] = {
    "header": ("name", "config"),
    "metrics": ("stream", "windows"),
    "grid_row": ("row",),
    "histogram": ("name", "hist"),
    "alert": ("rule", "severity", "detail"),
    "summary": ("data",),
}


def _sanitize(obj: Any) -> Any:
    """Map non-finite floats (NaN, +-inf) to null in an already-coerced
    plain-JSON tree — runs *after* numpy/torch coercion, so NaN inside arrays
    and numpy scalar NaN are caught too (they were not before v2)."""
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def _jsonable(obj: Any) -> Any:
    """Coerce numpy / torch scalars and arrays into plain JSON types; the
    non-finite sweep happens after coercion (``_sanitize``)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return _sanitize(obj.item())
    if hasattr(obj, "tolist"):
        return _sanitize(obj.tolist())
    return _sanitize(obj)


def _unique_path(path: str) -> str:
    """First free numbered sibling: ``x.jsonl``, ``x.2.jsonl``, ..."""
    if not os.path.exists(path):
        return path
    root, ext = os.path.splitext(path)
    n = 2
    while os.path.exists(f"{root}.{n}{ext}"):
        n += 1
    return f"{root}.{n}{ext}"


class RunLog:
    """Append-only JSONL writer for one run.

    ``RunLog("my_run", config={...})`` opens ``<results>/runlogs/my_run.jsonl``
    (via ``paths.runlog_path``) and writes the header; pass ``path=`` to
    override the location entirely.  An existing log at the target raises
    ``FileExistsError`` unless ``overwrite=True`` (clobber) or
    ``unique=True`` (write to the first free numbered sibling instead; the
    ``run`` name in every record stays as given).  Use as a context manager
    or call ``close``; ``summary`` is normally the last record you emit.
    """

    def __init__(
        self,
        run: str,
        config: Optional[dict] = None,
        path: Optional[str] = None,
        overwrite: bool = False,
        unique: bool = False,
    ):
        self.run = run
        self.path = path if path is not None else runlog_path(run)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        if os.path.exists(self.path) and not overwrite:
            if not unique:
                raise FileExistsError(
                    f"run log {self.path} already exists; pass overwrite=True to "
                    f"clobber it or unique=True to write a numbered sibling"
                )
            self.path = _unique_path(self.path)
        self._fh = open(self.path, "w")
        self.event("header", name=run, config=_jsonable(config or {}))

    # -- record emission -------------------------------------------------
    def event(self, event: str, **payload) -> dict:
        """Append one schema-checked record; returns it as written."""
        if event not in EVENT_TYPES:
            raise ValueError(f"unknown event type {event!r} (want one of {EVENT_TYPES})")
        missing = [k for k in _REQUIRED[event] if k not in payload]
        if missing:
            raise ValueError(f"event {event!r} missing required keys {missing}")
        rec = {
            "schema": SCHEMA_VERSION,
            "event": event,
            "run": self.run,
            "ts": round(time.time(), 3),
            **_jsonable(payload),
        }
        self._fh.write(json.dumps(rec, allow_nan=False) + "\n")
        self._fh.flush()
        return rec

    def metrics(self, stream: str, windows: dict, better: Optional[Dict[str, str]] = None) -> dict:
        """One windowed metric stream (the ``taps.window_reduce`` shape)."""
        return self.event("metrics", stream=stream, windows=windows, better=better or {})

    def grid_row(self, row: dict) -> dict:
        """One evaluation-grid row (selector × scenario sweeps)."""
        return self.event("grid_row", row=row)

    def histogram(self, name: str, hist) -> dict:
        """A ``trace.LatencyHistogram`` (or its ``to_record()`` dict)."""
        rec = hist.to_record() if hasattr(hist, "to_record") else dict(hist)
        return self.event("histogram", name=name, hist=rec)

    def alert(self, rule: str, severity: str, detail: dict, message: str = "") -> dict:
        """One detector firing (see ``alerts``)."""
        return self.event("alert", rule=rule, severity=severity, detail=detail, message=message)

    def summary(self, **data) -> dict:
        """The run's closing scalar digest (one per log, by convention)."""
        return self.event("summary", data=data)

    # -- lifecycle --------------------------------------------------------
    def close(self) -> str:
        """Flush and close the log file; returns its path. Idempotent."""
        if not self._fh.closed:
            self._fh.close()
        return self.path

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_runlog(path: str) -> List[dict]:
    """Parse a JSONL run log into its records (empty lines skipped).
    Reads every supported schema version (v1 logs have no ``ts``)."""
    records = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: invalid JSON ({e})") from e
    return records


def iter_metrics(records: List[dict]) -> Iterator[dict]:
    """The metric-stream records of a parsed run log."""
    return (r for r in records if r.get("event") == "metrics")


def iter_alerts(records: List[dict]) -> Iterator[dict]:
    """The alert records of a parsed run log (always empty for v1 logs)."""
    return (r for r in records if r.get("event") == "alert")


def validate_records(records: List[dict]) -> None:
    """Schema check for a parsed run log; raises ValueError on violation.

    Enforces: every record carries the envelope at a *supported* schema
    version (v1 records validate under v1 rules: no ``ts``, no ``alert``);
    the first record is the header; required payload keys per event type.
    """
    if not records:
        raise ValueError("empty run log")
    for i, rec in enumerate(records):
        schema = rec.get("schema")
        if schema not in SUPPORTED_SCHEMAS:
            raise ValueError(
                f"record {i}: schema {schema!r} not in supported versions {SUPPORTED_SCHEMAS}"
            )
        ev = rec.get("event")
        if ev not in EVENT_TYPES:
            raise ValueError(f"record {i}: unknown event {ev!r}")
        if schema < 2 and ev in _V2_EVENTS:
            raise ValueError(f"record {i}: event {ev!r} requires schema >= 2, got {schema}")
        if schema >= 2 and "ts" not in rec:
            raise ValueError(f"record {i}: schema {schema} record missing timestamp 'ts'")
        if "run" not in rec:
            raise ValueError(f"record {i}: missing run id")
        missing = [k for k in _REQUIRED[ev] if k not in rec]
        if missing:
            raise ValueError(f"record {i} ({ev}): missing keys {missing}")
    if records[0]["event"] != "header":
        raise ValueError("first record must be the header")

"""Stage annotations and host-side latency histograms (the port of
``repro.obs.trace``).

* ``stage(name)`` names a region of the round in ``torch.profiler`` traces
  and, on a CUDA host, as an NVTX range.  It runs on the host when the
  code runs: inside a round step that ``build_runner`` captures as a CUDA
  graph it fires once, at the capture, and the replays show as graph
  launches, not stages.
* ``SpanTimer``: a wall-clock span timer for host code (a serving loop):
  each ``span(name)`` context feeds a ``LatencyHistogram``, giving p50/p99
  latency from bucketed counts, never per-request storage.

``LatencyHistogram`` buckets are log-spaced between ``lo`` and ``hi``
seconds; quantiles interpolate within the winning bucket on cumulative
counts, while min/max/sum/count are tracked exactly.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["stage", "SpanTimer", "LatencyHistogram"]


@contextlib.contextmanager
def stage(name: str):
    """Annotate a named pipeline stage (allocate / sample / observe / update /
    credit) for the profiler timeline."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class LatencyHistogram:
    """Log-bucketed latency accumulator with exact min/max/sum/count.

    ``n_buckets`` edges are geometrically spaced over ``[lo, hi]`` seconds;
    observations outside the range clamp into the end buckets.  Quantiles
    interpolate linearly within the selected bucket, and are additionally
    clamped to the exact observed [min, max] so tiny samples cannot report
    a quantile outside the data.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 10.0, n_buckets: int = 64):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo}, hi={hi}")
        self.edges = np.geomspace(lo, hi, n_buckets + 1)
        self.counts = np.zeros(n_buckets, np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0

    def observe(self, seconds: float) -> None:
        """Record one sample; negative or non-finite values are dropped."""
        s = float(seconds)
        if not np.isfinite(s) or s < 0:
            return
        i = int(np.searchsorted(self.edges, s, side="right")) - 1
        self.counts[min(max(i, 0), len(self.counts) - 1)] += 1
        self.count += 1
        self.sum += s
        self.min = min(self.min, s)
        self.max = max(self.max, s)

    def quantile(self, q: float) -> float:
        """Approximate quantile (``q`` in [0, 1]) from bucket counts."""
        if self.count == 0:
            return float("nan")
        target = q * self.count
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target, side="left"))
        i = min(i, len(self.counts) - 1)
        prev = cum[i - 1] if i > 0 else 0
        in_bucket = self.counts[i]
        frac = (target - prev) / in_bucket if in_bucket else 0.0
        lo, hi = self.edges[i], self.edges[i + 1]
        return float(min(max(lo + frac * (hi - lo), self.min), self.max))

    @property
    def mean(self) -> float:
        """Exact mean of the observed samples (NaN when empty)."""
        return self.sum / self.count if self.count else float("nan")

    def summary(self) -> Dict[str, float]:
        """The JSON-ready digest the runlog/report layer emits."""
        return {
            "count": int(self.count),
            "mean_s": self.mean,
            "min_s": self.min if self.count else float("nan"),
            "max_s": self.max,
            "p50_s": self.quantile(0.50),
            "p90_s": self.quantile(0.90),
            "p99_s": self.quantile(0.99),
        }

    def to_record(self) -> dict:
        """Full serializable state (edges + counts) for the JSONL stream."""
        return {
            "edges_s": self.edges.tolist(),
            "counts": self.counts.tolist(),
            **self.summary(),
        }


class SpanTimer:
    """Wall-clock span timing into per-name ``LatencyHistogram`` s.

    >>> spans = SpanTimer()
    >>> with spans.span("request"):
    ...     serve_one()
    >>> spans.hist["request"].quantile(0.99)
    """

    def __init__(self, lo: float = 1e-6, hi: float = 10.0, n_buckets: int = 64):
        self._args = (lo, hi, n_buckets)
        self.hist: Dict[str, LatencyHistogram] = {}

    def get(self, name: str) -> LatencyHistogram:
        """The ``name`` histogram, created on first use."""
        h = self.hist.get(name)
        if h is None:
            h = self.hist[name] = LatencyHistogram(*self._args)
        return h

    @contextlib.contextmanager
    def span(self, name: str, annotate: bool = False):
        """Time a block into the ``name`` histogram; with ``annotate`` the
        span also lands in profiler timelines via ``stage``."""
        h = self.get(name)
        ctx: contextlib.AbstractContextManager = stage(name) if annotate else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        h.observe(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span digests, keyed by span name."""
        return {name: h.summary() for name, h in self.hist.items()}

    def quantile(self, name: str, q: float) -> Optional[float]:
        """Quantile of one span's histogram; None if the span never ran."""
        h = self.hist.get(name)
        return h.quantile(q) if h else None

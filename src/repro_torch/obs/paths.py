"""Where the port writes its run artifacts: the results tree of
``repro.obs.paths``, cut to what the port writes (the autotune cache).

``REPRO_RESULTS`` overrides the root; ``REPRO_BENCH_OUT`` alone moves it to
that directory's parent; ``REPRO_AUTOTUNE_DIR`` overrides the autotune
directory.  Env vars are read at call time, never cached, so tests and
harness code can redirect a single run.
"""
from __future__ import annotations

import os

__all__ = ["results_root", "autotune_dir", "autotune_path"]


def results_root() -> str:
    """The root of the results tree (no directory is created)."""
    root = os.environ.get("REPRO_RESULTS")
    if root:
        return root
    bench = os.environ.get("REPRO_BENCH_OUT")
    if bench:
        parent = os.path.dirname(os.path.normpath(bench))
        return parent or "."
    return "results"


def autotune_dir() -> str:
    """Where the kernel autotune cache lives (``REPRO_AUTOTUNE_DIR``
    overrides)."""
    return os.environ.get("REPRO_AUTOTUNE_DIR") or os.path.join(results_root(), "autotune")


def _ensure(path: str) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return path


def autotune_path(name: str = "autotune") -> str:
    """``<name>.json`` under the autotune dir; creates the directory."""
    return _ensure(os.path.join(autotune_dir(), f"{name}.json"))

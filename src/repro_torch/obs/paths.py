"""One results layout for everything the port writes (the port of
``repro.obs.paths``):

    <root>/                      results_root()
      bench/torch/               bench_dir()      -- BENCH_<name>.json
      runlogs/torch/             runlog_dir()     -- <run>.jsonl event streams
      autotune/                  autotune_dir()   -- torch_autotune.json
      <name>.json|.txt           artifact_path()  -- grid tables & other run products

The bench JSON and run logs sit in a ``torch`` directory of their own, so
the port's runs never overwrite the JAX package's files or its committed
baselines (``results/bench/baseline/``, ``results/runlogs/baseline/``).
``REPRO_RESULTS`` overrides the root; ``REPRO_BENCH_OUT`` overrides the
bench dir and, when it is the only override, moves the root to its parent;
``REPRO_AUTOTUNE_DIR`` overrides the autotune directory.  Env vars are read
at call time, never cached, so tests and harness code can redirect a single
run.
"""
from __future__ import annotations

import os

__all__ = [
    "results_root", "bench_dir", "runlog_dir", "autotune_dir",
    "artifact_path", "bench_path", "runlog_path", "autotune_path",
]


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


def bench_dir() -> str:
    """Where the port's ``BENCH_<name>.json`` files live."""
    return os.environ.get("REPRO_BENCH_OUT") or os.path.join(results_root(), "bench", "torch")


def runlog_dir() -> str:
    """Where the port's JSONL run logs live."""
    return os.path.join(results_root(), "runlogs", "torch")


def autotune_dir() -> str:
    """Where the kernel autotune cache lives (``REPRO_AUTOTUNE_DIR``
    overrides)."""
    return os.environ.get("REPRO_AUTOTUNE_DIR") or os.path.join(results_root(), "autotune")


def _ensure(path: str) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return path


def artifact_path(filename: str) -> str:
    """A non-bench run artifact (grid tables, figures) under the root;
    creates the directory."""
    return _ensure(os.path.join(results_root(), filename))


def bench_path(name: str) -> str:
    """``BENCH_<name>.json`` under the bench dir; creates the directory."""
    return _ensure(os.path.join(bench_dir(), f"BENCH_{name}.json"))


def runlog_path(run: str) -> str:
    """``<run>.jsonl`` under the runlog dir; creates the directory."""
    return _ensure(os.path.join(runlog_dir(), f"{run}.jsonl"))


def autotune_path(name: str = "autotune") -> str:
    """``<name>.json`` under the autotune dir; creates the directory."""
    return _ensure(os.path.join(autotune_dir(), f"{name}.json"))

"""Tile autotuning: sweep kernel launch configs once, cache winners on disk
(the port of ``repro.kernels.autotune``).

This module sweeps a small candidate grid per ``(kernel, K-bucket, dtype,
backend)`` through the port's own wrappers, on the card by default, and
persists the winners to a JSON cache, ``torch_autotune.json`` under
``results/autotune/`` (``REPRO_AUTOTUNE_DIR`` overrides, see
``repro_torch.obs.paths``; the file is the port's own, so a sweep never
rewrites the JAX package's ``autotune.json`` beside it).  ``ops.py``
consults the cache whenever a caller leaves ``tile=None``; callers that pass
an explicit tile are never affected.

Cache format (one flat JSON object, sorted keys)::

    {
      "bisect_tiles|K1048576|float32|cuda": {"tile": 16384, "block": 4},
      "gumbel_topk|K1048576|float32|cuda":  {"tile": 8192},
      ...
    }

K is bucketed to the next power of two (min 1024) so one sweep covers a
band of problem sizes; ``backend`` is the device type (``cuda`` or
``cpu``).  A corrupt or unreadable cache degrades to the defaults with a
warning: it never crashes a run.  Cold lookups (no cache entry) are
recorded (``cold_keys``).  The sweep is deterministic given fixed timings:
candidate order is fixed and ties break toward the earlier candidate.

Candidates differ from the JAX package's where the port's kernels take
other launch parameters:

* ``gumbel_topk``: ``tile`` is the keys a CTA of the top-k kernels' radix
  select takes per step of its row walks, 2048 to 16384.  A pair the
  kernel cannot take (``k`` above ``MAX_K``) raises ``UnsupportedLaunch``,
  and the sweep records that candidate as skipped.
* ``e3cs_tiles``: ``tile`` is the clients per CTA of the update kernel, as
  the JAX grid block (``tmax`` has the same shape).
* ``bisect_tiles``: as JAX (clients per CTA of the first pass; caps).
* ``round_fused``: only 4096, the select kernel's fixed step
  (``csrc/round_select.cu`` kSelectTile); its wrapper takes no tile.

The timer is the port's own ``time_fn``: on the card the device time of the
candidate's calls captured in one CUDA graph, so a pick follows device time
and not the host's dispatch; ``perf_counter`` on the CPU.
"""
from __future__ import annotations

import json
import os
import time
import warnings
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.paths import autotune_path

from ._build import UnsupportedLaunch

__all__ = [
    "DEFAULTS", "CANDIDATES", "CACHE_NAME", "cache_key", "load_cache", "save_cache",
    "best_config", "sweep", "autotune", "cold_keys", "reset_cold", "time_fn",
]

CACHE_NAME = "torch_autotune"

DEFAULTS: Dict[str, Dict[str, int]] = {
    "gumbel_topk": {"tile": 4096},  # the fastest B6 and B7 tile on the H100 (PERF.md, PR 14)
    "e3cs_tiles": {"tile": 8192},
    "bisect_tiles": {"tile": 8192, "block": 4},
    "round_fused": {"tile": 4096},
}

# Candidate grids.  "tile" is the launch tile of each kernel (see the module
# docstring); "block" is the bisection probe count exponent (2**block - 1
# probe points per sweep).
CANDIDATES: Dict[str, Dict[str, List[int]]] = {
    "gumbel_topk": {"tile": [2048, 4096, 8192, 16384]},
    "e3cs_tiles": {"tile": [2048, 4096, 8192, 16384, 32768]},
    "bisect_tiles": {"tile": [2048, 4096, 8192, 16384, 32768], "block": [2, 4, 6]},
    "round_fused": {"tile": [4096]},
}

_cache_memo: Tuple[Optional[str], Optional[float], Optional[dict]] = (None, None, None)
_cold: set = set()


def _bucket(K: int) -> int:
    """Power-of-two bucket (min 1024) so one sweep covers a size band."""
    return 1 << max(10, int(K - 1).bit_length())


def _default_backend() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def cache_key(kernel: str, K: int, dtype: str = "float32", backend: Optional[str] = None) -> str:
    backend = backend or _default_backend()
    return f"{kernel}|K{_bucket(K)}|{dtype}|{backend}"


def load_cache(path: Optional[str] = None) -> Dict[str, Dict[str, int]]:
    """Read the JSON cache; corrupt/missing degrades to ``{}`` (warn, never
    raise)."""
    path = path or autotune_path(CACHE_NAME)
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            cache = json.load(f)
        if not isinstance(cache, dict) or not all(isinstance(v, dict) for v in cache.values()):
            raise ValueError("autotune cache is not a {key: config} object")
    except (ValueError, OSError) as e:
        warnings.warn(f"ignoring corrupt autotune cache {path}: {e}", stacklevel=2)
        return {}
    return cache


def save_cache(cache: Dict[str, Dict[str, int]], path: Optional[str] = None) -> str:
    path = path or autotune_path(CACHE_NAME)
    with open(path, "w") as f:
        json.dump({k: cache[k] for k in sorted(cache)}, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def _cached(path: str) -> dict:
    """mtime-memoised cache read, so per-call lookups stay cheap while
    external writes (another process refreshing the cache) are picked up."""
    global _cache_memo
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        mtime = None
    memo_path, memo_mtime, memo_val = _cache_memo
    if memo_path == path and memo_mtime == mtime and memo_val is not None:
        return memo_val
    val = load_cache(path)
    _cache_memo = (path, mtime, val)
    return val


def best_config(kernel: str, K: int, dtype: str = "float32", backend: Optional[str] = None) -> Dict[str, int]:
    """Tuned launch config for ``kernel`` at size ``K``: cache hit merged
    over the defaults; a miss returns the defaults and is recorded as a cold
    lookup (see ``cold_keys``)."""
    base = dict(DEFAULTS.get(kernel) or {"tile": 8192})
    key = cache_key(kernel, K, dtype, backend)
    hit = _cached(autotune_path(CACHE_NAME)).get(key)
    if hit is None:
        _cold.add(key)
        return base
    base.update({k: int(v) for k, v in hit.items() if isinstance(v, (int, float))})
    return base


def cold_keys() -> List[str]:
    """Cache keys that were looked up but had no tuned entry, since the
    last ``reset_cold()``: a cold cache means timings reflect defaults."""
    return sorted(_cold)


def reset_cold() -> None:
    _cold.clear()


# ---------------------------------------------------------------------------
# Sweep harness
# ---------------------------------------------------------------------------


def time_fn(fn, *, iters: int = 3, warmup: int = 1, device=None) -> float:
    """Microseconds per call of ``fn()``.  On a CUDA device: ``iters`` calls
    captured in one CUDA graph, replayed once untimed, then timed by CUDA
    events around one replay: device time, no host dispatch; ``fn`` must
    not synchronise.  On the CPU: ``perf_counter`` around ``iters`` calls."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / max(iters, 1) * 1e6
    with torch.cuda.device(dev):
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(iters):
                fn()
        graph.replay()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
    return a.elapsed_time(b) / max(iters, 1) * 1e3


def _bench_builder(kernel: str, K: int, seed: int = 0, device=None):
    """A closure ``build(config) -> fn`` timing the wrappers production
    uses (the ops, or the kernel's own wrapper) under ``config``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    gen = torch.Generator(device=dev).manual_seed(seed)
    kk = max(8, min(K // 16, 1024))
    if kernel == "gumbel_topk":
        from repro_torch.core.selection.sampling import gumbel_row

        from . import ops

        p = t(np.abs(rng.normal(size=K)) + 1e-3)
        g = gumbel_row(gen, K, dev)

        def build(cfg):
            return lambda: ops.gumbel_topk_sample(g, p, kk, tile=cfg["tile"])
        return build
    if kernel == "e3cs_tiles":
        from . import ops

        logw = t(rng.normal(size=K))
        p = t(rng.uniform(0.05, 1.0, size=K))
        mask = t(rng.binomial(1, 0.2, size=K))
        x = t(rng.binomial(1, 0.6, size=K))
        frozen = torch.zeros(K, dtype=torch.float32, device=dev)
        scale = torch.full((), 0.1, dtype=torch.float32, device=dev)

        def build(cfg):
            return lambda: ops.e3cs_update_tiled(logw, p, mask, x, frozen, scale, tile=cfg["tile"])
        return build
    if kernel == "bisect_tiles":
        from .bisect_tiles import bisect_block_sums

        w = t(rng.uniform(0.0, 1.0, size=K))

        def build(cfg):
            n_caps = (1 << cfg.get("block", 4)) - 1
            caps = torch.linspace(0.01, 1.0, n_caps, dtype=torch.float32, device=dev)
            return lambda: bisect_block_sums(w, caps, tile=cfg["tile"])
        return build
    if kernel == "round_fused":
        from repro_torch.core.selection.sampling import gumbel_row
        from repro_torch.engine.sharded import masked_prob_alloc_scalars

        from .round_fused import fused_alloc_select

        w = t(rng.uniform(0.0, 1.0, size=K))
        sigma = torch.full((), 0.2 * kk / K, dtype=torch.float32, device=dev)
        scalars = masked_prob_alloc_scalars(w, kk, sigma)
        g = gumbel_row(gen, K, dev)

        def build(cfg):
            if cfg["tile"] not in CANDIDATES["round_fused"]["tile"]:
                raise UnsupportedLaunch(f"the select kernel's step is fixed at 4096, got tile={cfg['tile']}")
            return lambda: fused_alloc_select(w, g, kk, sigma=sigma, scalars=scalars)
        return build
    raise ValueError(f"unknown kernel {kernel!r}")


def _configs(kernel: str, candidates: Optional[Dict[str, List[int]]] = None) -> List[Dict[str, int]]:
    grid = candidates or CANDIDATES[kernel]
    axes = sorted(grid)
    configs: List[Dict[str, int]] = [{}]
    for ax in axes:
        configs = [dict(c, **{ax: v}) for c in configs for v in grid[ax]]
    return configs


def sweep(
    kernel: str,
    K: int,
    *,
    candidates: Optional[Dict[str, List[int]]] = None,
    timer=None,
    iters: int = 3,
    warmup: int = 1,
    seed: int = 0,
    device=None,
) -> Tuple[Dict[str, int], Dict[str, Any]]:
    """Time every candidate config for ``kernel`` at size ``K`` on
    ``device`` (the card by default); return ``(best_config,
    {json_config: us_per_call})``.  A candidate the kernel cannot take
    (``UnsupportedLaunch``) is not timed: its table entry is the string
    ``"skipped: <reason>"``.  ``timer`` is injectable for deterministic
    tests; the default is ``time_fn`` on ``device``."""
    dev = resolve_device(device)
    if timer is None:
        def timer(fn, iters, warmup, blocking):  # the injectable timer's signature; the graph never blocks
            return time_fn(fn, iters=iters, warmup=warmup, device=dev)
    build = _bench_builder(kernel, K, seed=seed, device=dev)
    table: Dict[str, Any] = {}
    best_cfg: Optional[Dict[str, int]] = None
    best_us = float("inf")
    for cfg in _configs(kernel, candidates):
        name = json.dumps(cfg, sort_keys=True)
        try:
            us = float(timer(build(cfg), iters=iters, warmup=warmup, blocking=True))
        except UnsupportedLaunch as e:
            table[name] = f"skipped: {e}"
            continue
        table[name] = us
        if us < best_us:  # strict: ties keep the earlier candidate
            best_us, best_cfg = us, dict(cfg)
    if best_cfg is None:
        raise UnsupportedLaunch(f"no candidate of {kernel!r} runs at K={K}: {table}")
    return best_cfg, table


def autotune(
    kernels: Optional[Iterable[str]] = None,
    K_list: Iterable[int] = (10_000,),
    *,
    path: Optional[str] = None,
    save: bool = True,
    timer=None,
    iters: int = 3,
    warmup: int = 1,
    device=None,
) -> Dict[str, Any]:
    """Run the sweep for every (kernel, K) pair on ``device`` (the card by
    default) and merge winners into the on-disk cache.  Returns ``{"cache":
    ..., "tables": ..., "path": ...}``."""
    dev = resolve_device(device)
    kernels = list(kernels) if kernels is not None else sorted(CANDIDATES)
    path = path or autotune_path(CACHE_NAME)
    cache = load_cache(path)
    tables: Dict[str, Dict[str, Any]] = {}
    for kern in kernels:
        for K in K_list:
            best, table = sweep(kern, int(K), timer=timer, iters=iters, warmup=warmup, device=dev)
            key = cache_key(kern, int(K), backend=dev.type)
            cache[key] = best
            tables[key] = table
    if save:
        save_cache(cache, path)
        global _cache_memo
        _cache_memo = (None, None, None)
    return {"cache": cache, "tables": tables, "path": path}


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="regenerate the port's autotune cache (on the card by default)")
    ap.add_argument("--K", type=int, nargs="+", default=[10_000, 100_000, 1_000_000])
    ap.add_argument("--kernels", nargs="+", default=None)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    out = autotune(args.kernels, args.K, iters=args.iters, device=args.device)
    print(f"wrote {out['path']}")
    for key, tab in out["tables"].items():
        win = json.dumps(out["cache"][key], sort_keys=True)
        print(f"  {key}: {win}")

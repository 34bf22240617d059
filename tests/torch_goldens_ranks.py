"""The port's side of ``tests/test_torch_goldens.py``, without JAX: the
entry points ``tests/golden/gen_goldens.py`` calls, with its arguments, run in the
port under ``core.prng.threefry_partitionable(False)`` (the mode the
goldens were written in).  ``d8_cells`` runs on a spawned gloo rank of an
8-rank group (``test_torch_mesh.spawn_groups``), and ``chip_smoke.py`` runs
``port_cell`` on the card, so this module imports no JAX."""
import os

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.volatility import CompletionLag, make_volatility, paper_success_rates
from repro_torch.engine.scan_sim import async_selection_sim, scan_selection_sim
from repro_torch.engine.sharded import sharded_selection_sim
from repro_torch.scenarios.replay import ReplayLag, pack_trace, record_lag_trace, replay_packed_stream, \
    save_packed_trace

K, k, T, SEED, FRAC = 128, 16, 50, 3, 0.5  # gen_goldens.py's
SYNC_SCHEMES = ("e3cs", "random", "fedcs", "ucb", "pow_d")
ASYNC_SCHEMES = ("e3cs", "random", "ucb", "fedcs")
ASYNC_FIELDS = ("masks", "lags", "counts", "cep", "on_time", "stale")

# each cell of gen_goldens.py and the arrays it writes, in its order
CELLS = (
    *((f"sync_{s}", (f"sync_d1_{s}_masks", f"sync_d1_{s}_counts")) for s in SYNC_SCHEMES),
    ("sync_bisect", ("sync_d1_e3cs_bisect_masks",)),
    ("sync_dense", ("sync_d1_dense_masks",)),
    ("sync_packed", ("sync_d1_packed_masks",)),
    ("sync_streamed", ("sync_d1_streamed_successes", "sync_d1_streamed_counts")),
    ("d8", ("sync_d8_e3cs_masks", "sync_d8_e3cs_counts", "sync_d8_random_masks", "sync_d8_random_counts",
            "sync_d8_packed_masks")),
    *((f"async_{s}", tuple(f"async_d1_{s}_{f}" for f in ASYNC_FIELDS)) for s in ASYNC_SCHEMES),
    ("lag_trace", ("lag_trace_packed",)),
    ("async_replay", ("async_d1_replay_masks", "async_d1_replay_counts", "async_d1_replay_cep")),
)
KW = dict(K=K, k=k, T=T, frac=FRAC, seed=SEED)


def dense_xs():
    return np.random.default_rng(11).binomial(1, 0.6, (T, K)).astype(np.float32)


def lag_model(rho, device="cpu"):
    return CompletionLag(make_volatility("bernoulli", rho, device=device), p_late=0.7, lag_decay=0.5, max_lag=2)


def port_cell(name, tmp_dir, device="cpu"):
    """Cell ``name`` of ``CELLS`` (not ``d8``) in the port on ``device``
    under the original threefry mode: its arrays by name, as numpy."""
    rho = paper_success_rates(K)

    def _async(scheme, model):
        return async_selection_sim(scheme, staleness=2, alpha=0.5, lag_model=model, rho=rho, device=device, **KW)

    with prng.threefry_partitionable(False):
        if name.startswith("sync_") and name[5:] in SYNC_SCHEMES:
            out = scan_selection_sim(name[5:], device=device, **KW)
            return {f"sync_d1_{name[5:]}_masks": pack_trace(out["masks"]), f"sync_d1_{name[5:]}_counts": out["counts"]}
        if name == "sync_bisect":
            out = scan_selection_sim("e3cs", allocator="bisect", device=device, **KW)
            return {"sync_d1_e3cs_bisect_masks": pack_trace(out["masks"])}
        if name == "sync_dense":
            out = scan_selection_sim("e3cs", xs_override=dense_xs(), device=device, **KW)
            return {"sync_d1_dense_masks": pack_trace(out["masks"])}
        if name == "sync_packed":
            out = scan_selection_sim("e3cs", packed_override=pack_trace(dense_xs()), device=device, **KW)
            return {"sync_d1_packed_masks": pack_trace(out["masks"])}
        if name == "sync_streamed":
            path = save_packed_trace(os.path.join(str(tmp_dir), "trace"), pack_trace(dense_xs()), K)
            out = replay_packed_stream("e3cs", path, k, chunk=16, frac=FRAC, seed=SEED, device=device)
            return {"sync_d1_streamed_successes": out["successes"], "sync_d1_streamed_counts": out["counts"]}
        if name.startswith("async_") and name[6:] in ASYNC_SCHEMES:
            s = name[6:]
            out = _async(s, lag_model(rho, device))
            return {f"async_d1_{s}_masks": pack_trace(out["masks"]), f"async_d1_{s}_lags": out["lags"].astype(np.int8),
                    f"async_d1_{s}_counts": out["counts"], f"async_d1_{s}_cep": np.float32(out["cep"]),
                    f"async_d1_{s}_on_time": out["on_time"], f"async_d1_{s}_stale": out["stale"]}
        if name == "lag_trace":
            return {"lag_trace_packed": record_lag_trace(lag_model(rho, device), T, seed=SEED, device=device)}
        if name == "async_replay":
            lags = record_lag_trace(lag_model(rho, device), T, seed=SEED, device=device)
            out = _async("e3cs", ReplayLag(torch.as_tensor(lags, device=device), K))
            return {"async_d1_replay_masks": pack_trace(out["masks"]), "async_d1_replay_counts": out["counts"],
                    "async_d1_replay_cep": np.float32(out["cep"])}
    raise ValueError(f"unknown cell {name!r}")


def d8_cells(mesh):
    """The D = 8 cells on this rank of ``mesh`` under the original mode:
    every rank returns the whole masks and counts."""
    out = {}
    with prng.threefry_partitionable(False):
        for scheme in ("e3cs", "random"):
            res = sharded_selection_sim(scheme, mesh, device="cpu", **KW)
            out[f"sync_d8_{scheme}_masks"] = pack_trace(res["masks"])
            out[f"sync_d8_{scheme}_counts"] = res["counts"]
        res = sharded_selection_sim("e3cs", mesh, packed_override=pack_trace(dense_xs()), device="cpu", **KW)
        out["sync_d8_packed_masks"] = pack_trace(res["masks"])
    return out

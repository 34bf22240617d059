"""Scenario subsystem: volatility as a workload axis (the port of
``repro.scenarios``).

* ``traces``: structured generators (diurnal, regional outages, flash
  crowds) in the draw protocol of ``repro_torch.core.volatility``;
* ``replay``: bit-packed trace recording and replay, byte for byte the JAX
  package's format, streamed through the captured round step;
* ``registry``: named scenario configurations;
* ``harness``: the selector x scenario evaluation grid.
"""
from .traces import DiurnalVolatility, FlashCrowdVolatility, RegionalOutageVolatility
from .replay import (
    ReplayLag,
    ReplayVolatility,
    lag_packed_width,
    load_packed_trace,
    pack_lags,
    pack_trace,
    packed_nbytes,
    packed_width,
    record_lag_trace,
    record_trace,
    replay_packed_stream,
    save_packed_trace,
    unpack_lags,
    unpack_trace,
)
from .registry import SCENARIOS, Scenario, get_scenario, list_scenarios, make_scenario
from .harness import evaluate_cell, format_grid, run_grid, run_grid_multi_job, run_replay

__all__ = [
    "DiurnalVolatility",
    "FlashCrowdVolatility",
    "RegionalOutageVolatility",
    "ReplayLag",
    "ReplayVolatility",
    "lag_packed_width",
    "load_packed_trace",
    "pack_lags",
    "pack_trace",
    "packed_nbytes",
    "packed_width",
    "record_lag_trace",
    "record_trace",
    "replay_packed_stream",
    "save_packed_trace",
    "unpack_lags",
    "unpack_trace",
    "SCENARIOS",
    "Scenario",
    "get_scenario",
    "list_scenarios",
    "make_scenario",
    "evaluate_cell",
    "format_grid",
    "run_grid",
    "run_grid_multi_job",
    "run_replay",
]

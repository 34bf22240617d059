from .aggregation import aggregate, aggregate_async, staleness_weights
from .client import make_local_update, prox_penalty
from .round import (
    ServerState,
    init_server_state,
    make_async_cohort_round,
    make_cohort_round,
    make_select_fn,
    make_silo_steps,
)
from .server import FLServer, build_volatility

__all__ = [
    "ServerState",
    "init_server_state",
    "make_select_fn",
    "make_cohort_round",
    "make_async_cohort_round",
    "make_silo_steps",
    "make_local_update",
    "prox_penalty",
    "aggregate",
    "aggregate_async",
    "staleness_weights",
    "FLServer",
    "build_volatility",
]

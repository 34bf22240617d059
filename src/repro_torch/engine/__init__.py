from .round_program import RoundNoise, RoundProgram, lag_credit_schedule, ring_pop_push, staleness_ring_step
from .scan_sim import async_selection_sim, build_scan_runner, make_sim_step, scan_selection_sim
from .sharded import masked_prob_alloc, sharded_selection_sim

__all__ = [
    "RoundNoise",
    "RoundProgram",
    "lag_credit_schedule",
    "ring_pop_push",
    "staleness_ring_step",
    "async_selection_sim",
    "build_scan_runner",
    "make_sim_step",
    "scan_selection_sim",
    "masked_prob_alloc",
    "sharded_selection_sim",
]

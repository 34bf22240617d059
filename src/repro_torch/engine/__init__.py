"""Fleet-scale selection engine (the port of ``repro.engine``).

* ``round_program``: the one round body (allocate -> select -> observe ->
  credit -> update), by placement, staleness and feedback policy;
* ``scan_sim``: whole-horizon simulators over the captured runner;
* ``sharded``: the sort-free allocator and the K-sharded mesh placement;
* ``multi_job``: the batched multi-tenant engine (J concurrent jobs a step).
"""
from .round_program import RoundNoise, RoundProgram, lag_credit_schedule, ring_pop_push, staleness_ring_step
from .scan_sim import async_selection_sim, build_scan_runner, make_sim_step, scan_selection_sim
from .sharded import (
    build_sharded_scan_runner,
    distributed_topk,
    masked_prob_alloc,
    plackett_luce_shmap,
    prob_alloc_sharded,
    prob_alloc_shmap,
    sharded_selection_sim,
)
from .multi_job import (
    MultiJobConfig,
    MultiJobState,
    make_multi_job,
    multi_job_init,
    pack_jobs,
    pad_slots,
    slot_admit,
    slot_retire,
)

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
    "build_sharded_scan_runner",
    "distributed_topk",
    "masked_prob_alloc",
    "plackett_luce_shmap",
    "prob_alloc_sharded",
    "prob_alloc_shmap",
    "sharded_selection_sim",
    "MultiJobConfig",
    "MultiJobState",
    "make_multi_job",
    "multi_job_init",
    "pack_jobs",
    "pad_slots",
    "slot_admit",
    "slot_retire",
]

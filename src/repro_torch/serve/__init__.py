"""repro_torch.serve — the selection service (the port of ``repro.serve``):
a callable front end for the engine.

The engine packages (``repro_torch.engine``) capture selection *loops*;
this package makes them a *service* a fleet coordinator can call one round
at a time, on the card, without giving up the captured steady state:

* :mod:`repro_torch.serve.protocol` — stdlib-only wire format: length-prefixed
  JSON frames, packed feedback encodings (success bits / lag codes).
* :mod:`repro_torch.serve.engines` — the serving backends: ``SlotEngine`` (J
  tenant jobs as padding-mask slots of one graph replay, bucket-ladder
  growth, no new capture on join/leave) and ``ShardedEngine`` (one K-sharded
  ``RoundProgram`` per job, sync or async; on D > 1 ranks rank 0 leads and
  the others ``follow``).
* :mod:`repro_torch.serve.transport` — ``SelectionServer``: socket front end,
  streaming batcher, bounded-queue backpressure (shed), request deadlines,
  periodic checkpoint, graceful drain.
* :mod:`repro_torch.serve.state` — elastic restart: engine meta + array
  checkpoints through ``repro_torch.checkpoint``; a restored server continues
  bit-identically mid-horizon.
* :mod:`repro_torch.serve.client` — the thin synchronous client (reconnecting,
  with seeded-backoff retries for idempotent requests).
* :mod:`repro_torch.serve.faults` — seeded chaos schedules (``FaultPlan``):
  engine crashes, checkpoint corruption, dropped connections, slow
  dispatches — all behind no-op defaults.

Wire contract and failure modes: ``docs/serving.md`` (the JAX package's;
the port keeps its frames, ops and error codes).  Nothing here imports
``msgpack`` or ``zstandard``.
"""
from .client import ServeClient, ServeError
from .engines import CapacityError, EngineSuperseded, JobSpec, NumericsError, ShardedEngine, SlotEngine
from .engines import engine_from_meta, follow, stop_followers
from .faults import EngineCrash, FaultPlan
from .state import latest_server_checkpoint, load_server, save_server, validate_stem
from .transport import SelectionServer

__all__ = [
    "ServeClient",
    "ServeError",
    "CapacityError",
    "JobSpec",
    "NumericsError",
    "SlotEngine",
    "ShardedEngine",
    "EngineSuperseded",
    "follow",
    "stop_followers",
    "engine_from_meta",
    "EngineCrash",
    "FaultPlan",
    "save_server",
    "load_server",
    "latest_server_checkpoint",
    "validate_stem",
    "SelectionServer",
]

"""Deterministic, seeded fault injection for the serving front end (a copy
of ``repro.serve.faults``).

The paper's premise is client volatility; this module makes the *server*
volatile on purpose, so the fault-tolerance layer (supervised engine
recovery, idempotent retries, crash-safe checkpoints) can be proven rather
than trusted.  A :class:`FaultPlan` is a schedule of four fault kinds, each
keyed on a monotone event counter the serving stack already advances:

* **engine-step crashes** — ``on_engine_step`` raises :class:`EngineCrash`
  at scheduled engine dispatch indices (hooked at the top of
  ``SlotEngine.tick`` / ``ShardedEngine.tick``, before any state mutates).
  The transport's supervisor catches the crash, fails in-flight requests
  with ``error: "retry"`` and restores the engine from the newest *valid*
  checkpoint.
* **checkpoint corruption** — ``on_checkpoint`` truncates or bit-flips the
  ``.ckpt`` payload of scheduled checkpoint writes *after* they land on
  disk (hooked in ``repro_torch.serve.state.save_server``).  The sha256 recorded
  in the meta sidecar no longer matches, so the restore walk-back must skip
  the stem.
* **connection drops** — ``on_response`` cuts the client's connection
  instead of sending scheduled responses (hooked in the transport's
  connection handler, *after* the request executed).  The client's reply is
  lost exactly like a network failure; only the idempotent tick cache makes
  the retry safe.
* **slow dispatches** — ``on_engine_step`` sleeps at scheduled indices
  before the step runs, stretching queue residency so deadline/backpressure
  paths see load without a load generator.

Schedules are explicit index tuples (bit-reproducible by construction) or
drawn once by :meth:`FaultPlan.sample` from a seeded generator.  A plan with
empty schedules is a no-op, and every hook is behind an ``if plan is not
None`` in the serving stack, so the hot path is untouched when chaos is off.

Counters advance under a lock; engine-step and checkpoint counters are
driven by the single engine thread (deterministic order), the response
counter by connection handlers (deterministic for a sequential client, the
chaos harness's shape).
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, Optional, Tuple

__all__ = ["EngineCrash", "FaultPlan"]


class EngineCrash(RuntimeError):
    """A fault-injected crash of the engine step (the supervisor's cue)."""


@dataclasses.dataclass
class FaultPlan:
    """One seeded chaos schedule (see module docstring).

    All indices are 0-based event counts: ``crash_steps`` / ``slow_steps``
    count engine dispatches, ``corrupt_checkpoints`` counts checkpoint
    writes, ``drop_responses`` counts responses the transport was about to
    send.  ``fired()`` reports how many of each actually triggered, so a
    chaos test can assert its schedule really ran.
    """

    crash_steps: Tuple[int, ...] = ()
    corrupt_checkpoints: Tuple[int, ...] = ()
    drop_responses: Tuple[int, ...] = ()
    slow_steps: Optional[Dict[int, float]] = None
    corrupt_mode: str = "truncate"  # or "bitflip"

    def __post_init__(self):
        if self.corrupt_mode not in ("truncate", "bitflip"):
            raise ValueError(f"unknown corrupt_mode {self.corrupt_mode!r}")
        self.crash_steps = tuple(int(i) for i in self.crash_steps)
        self.corrupt_checkpoints = tuple(int(i) for i in self.corrupt_checkpoints)
        self.drop_responses = tuple(int(i) for i in self.drop_responses)
        self.slow_steps = {int(k): float(v) for k, v in (self.slow_steps or {}).items()}
        self._lock = threading.Lock()
        self._n_step = 0
        self._n_ckpt = 0
        self._n_resp = 0
        self._fired = {"crash": 0, "corrupt": 0, "drop": 0, "slow": 0}

    @classmethod
    def sample(
        cls,
        seed: int,
        *,
        n_steps: int,
        crashes: int = 1,
        corruptions: int = 1,
        drops: int = 2,
        slow: int = 1,
        slow_s: float = 0.01,
        first_step: int = 4,
        corrupt_mode: str = "truncate",
    ) -> "FaultPlan":
        """Draw one schedule from a seeded generator: ``crashes`` engine
        crashes and ``slow`` slow dispatches among steps ``[first_step,
        n_steps)``, ``corruptions`` corrupted checkpoint writes (never the
        very first, so a valid restore point always exists), and ``drops``
        dropped responses.  Same seed, same plan — always."""
        import numpy as np

        rng = np.random.default_rng(seed)
        lo = min(first_step, max(n_steps - 1, 0))
        steps = rng.choice(
            np.arange(lo, max(n_steps, lo + 1)),
            size=min(crashes + slow, max(n_steps - lo, 1)),
            replace=False,
        )
        return cls(
            crash_steps=tuple(sorted(int(s) for s in steps[:crashes])),
            corrupt_checkpoints=tuple(sorted(1 + int(i) for i in rng.choice(
                max(n_steps // 4, 1), size=min(corruptions, max(n_steps // 4, 1)), replace=False
            ))),
            drop_responses=tuple(sorted(int(i) for i in rng.choice(
                np.arange(lo, max(n_steps, lo + 1)), size=min(drops, max(n_steps - lo, 1)),
                replace=False,
            ))),
            slow_steps={int(s): slow_s for s in steps[crashes:]},
            corrupt_mode=corrupt_mode,
        )

    # -- hooks (each no-op unless its schedule names the current index) ----

    def on_engine_step(self) -> None:
        """Engine-dispatch hook: sleep on a scheduled slow step, raise
        :class:`EngineCrash` on a scheduled crash step."""
        with self._lock:
            idx = self._n_step
            self._n_step += 1
            crash = idx in self.crash_steps
            delay = self.slow_steps.get(idx, 0.0)
            if crash:
                self._fired["crash"] += 1
            if delay:
                self._fired["slow"] += 1
        if delay:
            time.sleep(delay)
        if crash:
            raise EngineCrash(f"fault-injected crash at engine step {idx}")

    def on_checkpoint(self, stem: str) -> None:
        """Checkpoint-write hook: corrupt ``<stem>.ckpt`` in place on a
        scheduled write (truncate to half, or flip one payload byte)."""
        with self._lock:
            idx = self._n_ckpt
            self._n_ckpt += 1
            if idx not in self.corrupt_checkpoints:
                return
            self._fired["corrupt"] += 1
        path = stem + ".ckpt"
        size = os.path.getsize(path)
        if self.corrupt_mode == "truncate":
            with open(path, "r+b") as f:
                f.truncate(size // 2)
        else:
            with open(path, "r+b") as f:
                f.seek(size // 2)
                b = f.read(1)
                f.seek(size // 2)
                f.write(bytes([b[0] ^ 0xFF]))

    def on_response(self) -> bool:
        """Response hook: return True when the transport should cut the
        connection instead of sending this response."""
        with self._lock:
            idx = self._n_resp
            self._n_resp += 1
            if idx in self.drop_responses:
                self._fired["drop"] += 1
                return True
        return False

    # -- introspection -----------------------------------------------------

    def fired(self) -> Dict[str, int]:
        """How many faults of each kind actually triggered so far."""
        with self._lock:
            return dict(self._fired)

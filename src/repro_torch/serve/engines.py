"""Serving engines: the selection backends behind the transport (the port of
``repro.serve.engines``).

Two backends, one interface (``admit`` / ``retire`` / ``job_round`` /
``tick`` / ``meta`` / ``arrays`` / ``load_arrays`` / ``from_meta``):

* :class:`SlotEngine`, the multi-tenant **streaming batcher** backend.  J
  tenant jobs live as padding-mask *slots* of one ``(J, K_max)``-packed
  ``engine.multi_job`` step, so a whole fleet tick is one dispatch: on a
  CUDA device one CUDA-graph replay over static buffers (``_SlotStep``).
  Admitting and retiring jobs edit slot rows (``slot_admit`` /
  ``slot_retire``): data changes, shapes don't, so join and leave never
  capture again.  When every slot is occupied the batch grows along a fixed
  **bucket ladder** (4, 8, 16, ... slots), one capture a bucket reached.
  ``staleness=S`` adds the bounded ``(J, S, K_max)`` late-credit ring.
* :class:`ShardedEngine`, the fleet-scale backend: each job is a full
  K-sharded ``RoundProgram`` on the caller's process group, stepped by a
  ``build_runner(outputs="full", carry_key=True, scan_length=1)`` runner (one
  graph replay a tick; uncaptured on a gloo group), so successive ticks
  resume the horizon bit for bit.  ``staleness=S`` serves the sharded-async
  composition, rings carried per job.  Jobs of one geometry share one
  runner.  On D > 1 ranks rank 0 leads (the engine and its server) and the
  other ranks run ``follow``, which mirrors each command rank 0 sends.

A job's noise depends only on its own seed and round counter, never on its
slot, its co-tenants, the batch width or a restart: the slot engine draws job
round ``t``'s Gumbel row from a generator seeded by ``SeedSequence([seed,
t])`` (``gumbel_row``), the sharded engine carries each job's generator
state.  So a job's cohorts are a pure function of (spec, feedback history),
and three things follow, as in the JAX package: batching invariance,
elastic restart (``arrays`` / ``load_arrays`` round-trip the whole evolving
state through ``repro_torch.checkpoint``), and replayability.

The noise is the engine's ``stream``.  An engine built in the port draws from
Philox (``"philox"``), as above.  ``stream="jax"`` follows the JAX package's
key stream (``core.prng``) seed for seed: the slot engine draws job round
``t``'s row as ``gumbel(fold_in(base_key, t), (K_max,))`` with ``base_key =
PRNGKey(seed)`` carried per slot (``base_keys``, as JAX's engine), and the
sharded engine carries each job's JAX key through its ``carry_key`` runner,
each in the threefry mode that was the default when the engine was built
(``core.prng.threefry_partitionable``; a sharded engine's followers take
the leader's).
``meta()`` records the JAX stream and its mode (a Philox engine's meta is
the JAX engine's, field for field) and ``engine_from_meta`` rebuilds the
engine in them, so restored jobs, and jobs admitted after a restore,
follow the stream (a meta naming no mode, a JAX stem's, takes the current
default, as JAX's engine follows its config); ``serve.state.load_server``
builds a JAX stem's engine on it, so a service checkpointed by the JAX
package continues on the card with the cohorts the JAX service would have
served.

Feedback is the population's completion-lag codes for the round being
issued: 0 on time, ``1..S`` late, ``DEAD_LAG`` never.  Every entry point
runs on CUDA unless given ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.prng import Key, PRNGKey, default_partitionable, fold_in, gumbel, threefry_partitionable
from repro_torch.core.selection.sampling import gumbel_from_uniform
from repro_torch.device import resolve_device
from repro_torch.engine.multi_job import MultiJobConfig, MultiJobState, job_generator, pad_slots, plain_batched_step
from repro_torch.engine.multi_job import slot_admit, slot_retire
from repro_torch.engine.round_program import capture_step, staleness_ring_step
from repro_torch.kernels import add_launch_counts

__all__ = [
    "JobSpec",
    "CapacityError",
    "NumericsError",
    "SlotEngine",
    "ShardedEngine",
    "EngineSuperseded",
    "follow",
    "stop_followers",
    "engine_from_meta",
    "STREAMS",
]

_f32 = torch.float32
STREAMS = ("philox", "jax")  # an engine's noise: the port's own, or the JAX package's key stream


def _check_stream(stream: str) -> str:
    if stream not in STREAMS:
        raise ValueError(f"unknown noise stream {stream!r} (want one of {STREAMS})")
    return stream


def _stream_meta(stream: str, partitionable: bool) -> dict:
    """The noise stream's entry in an engine's ``meta()``: named, with its
    threefry mode, when it is the JAX key stream, absent for Philox (the
    meta JAX's engine writes)."""
    return {"stream": stream, "threefry_partitionable": partitionable} if stream != "philox" else {}


def _meta_mode(meta: dict):
    """The threefry mode an engine is rebuilt in: its meta's, or where the
    meta names none (a JAX package stem) the current default, as JAX's
    engine follows its config."""
    return threefry_partitionable(meta.get("threefry_partitionable", default_partitionable()))


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One tenant job's declaration, as posted with the ``admit`` op.

    ``sigma_frac`` is the fairness floor as a fraction of the uniform rate
    ``k/K`` (``sigma = sigma_frac * k / K``); ``rounds`` is the job's
    declared horizon: the :class:`ShardedEngine` quota schedule spans it
    (the :class:`SlotEngine` holds sigma constant, the ``multi_job``
    semantics).  ``seed`` fully determines the job's noise.
    """

    K: int
    k: int
    rounds: int = 400
    sigma_frac: float = 0.5
    eta: float = 0.5
    quota: str = "const"
    seed: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "JobSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - fields
        if unknown:
            raise ValueError(f"unknown JobSpec fields {sorted(unknown)}")
        return cls(**{k: v for k, v in obj.items() if k in fields})


class CapacityError(RuntimeError):
    """No free slot and the bucket ladder is exhausted: shed the admit."""


class NumericsError(RuntimeError):
    """A selector update produced NaN/inf log-weights.  The update was
    **refused** (engine state is unchanged), so a numerical blowup is never
    checkpointed; the transport answers ``error: "numerics"`` and raises an
    alert."""


# ---------------------------------------------------------------------------
# SlotEngine: the streaming-batcher backend
# ---------------------------------------------------------------------------


class _SlotStep:
    """The service step of one bucket width J over static buffers (JAX's
    ``SlotEngine._build_step``): the config rows, the state (``logw``,
    ``t``, the ring), this tick's Gumbel rows ``g``, lag codes and
    participation gate, and ``out``, one int32 vector holding ``idx``
    ``(J, k_cap)``, the float32 bits of ``on_time`` and ``stale`` ``(J,)``
    and the ``finite`` flag, so the host reads a tick in one copy.

    The step writes the new state into its buffers, gated: a slot that does
    not tick keeps its weights, counter and ring; a non-finite updated
    log-weight in any ticking slot keeps the whole batch as it was (the
    guard) and clears ``finite``.  On a CUDA device the first ``run`` warms
    the step up and captures it as a CUDA graph, then puts the state back as
    it was; every ``run`` replays it.  On the CPU ``run`` calls the same step
    on the same buffers.
    """

    def __init__(self, cfg: MultiJobConfig, state: MultiJobState, pending: torch.Tensor, k_cap: int, S: int,
                 alpha: float, n_iters: int, tile: int):
        J, K_max = cfg.active.shape
        dev = cfg.active.device
        self.cfg, self.state, self.pending = cfg, state, pending
        self.k_cap, self.S, self.alpha, self.n_iters, self.tile = k_cap, S, alpha, n_iters, tile
        self.g = torch.zeros((J, K_max), dtype=_f32, device=dev)
        self.lag = torch.zeros((J, K_max), dtype=torch.int32, device=dev)
        self.participate = torch.zeros((J,), dtype=torch.bool, device=dev)
        self.out = torch.zeros((J * k_cap + 2 * J + 1,), dtype=torch.int32, device=dev)
        self.graph, self.per_replay, self.warmup_s, self.capture_s = None, {}, None, None

    def _body(self) -> None:
        cfg, part, S = self.cfg, self.participate, self.S
        logw, t = self.state
        x = (self.lag == 0).to(_f32) * cfg.active
        new, out = plain_batched_step(cfg, self.state, self.g, x, k_max=self.k_cap, n_iters=self.n_iters,
                                      tile=self.tile)
        # dead slots step to NaN (an empty active mask) and are gated out:
        # only ticking slots can refuse the batch
        finite = torch.all(torch.isfinite(new.logw) | ~part[:, None])
        pj = part.to(_f32)
        keep = pj * finite.to(_f32)
        mask = out["mask"] * pj[:, None]
        arriving, new_pending = staleness_ring_step(self.pending, mask, self.lag, S, self.alpha)
        on_time = torch.sum(mask * x, dim=1)
        stale = torch.sum(arriving * pj[:, None], dim=1)
        idx = torch.where(part[:, None], out["idx"], torch.full_like(out["idx"], -1))
        logw.copy_(torch.where(keep[:, None] > 0, new.logw, logw))
        t.copy_(torch.where(part & finite, new.t, t))
        if S:
            self.pending.copy_(torch.where(keep[:, None, None] > 0, new_pending, self.pending))
        self.out.copy_(torch.cat([idx.reshape(-1), on_time.view(torch.int32), stale.view(torch.int32),
                                  finite.to(torch.int32).reshape(1)]))

    def run(self) -> None:
        dev = self.g.device
        if dev.type != "cuda":
            self._body()
            return
        if self.graph is None:
            held = [v.clone() for v in (*self.state, self.pending)]
            self.graph, _, self.per_replay, self.warmup_s, self.capture_s = capture_step(dev, self._body, self._body)
            for buf, v in zip((*self.state, self.pending), held):
                buf.copy_(v)
        self.graph.replay()
        add_launch_counts(self.per_replay)


class SlotEngine:
    """Multi-tenant batched engine with padding-mask slots (see the module
    docstring).

    ``buckets`` is the slot-count ladder: the engine starts at the smallest
    bucket and grows (``pad_slots``) when admits exceed it, one capture a
    bucket ever reached.  ``k_cap`` bounds every job's cohort (the padded
    top-k width is static in the step; the exact top-k kernel ranks a row
    where ``k_cap <= 2048``, a stable sort above).  ``stream`` is the noise
    (module docstring).  ``device=None`` means CUDA.
    """

    kind = "slots"

    def __init__(
        self,
        K_max: int = 4096,
        k_cap: Optional[int] = None,
        staleness: int = 0,
        alpha: float = 0.5,
        buckets: Sequence[int] = (4, 8, 16, 32, 64),
        n_iters: int = 48,
        tile: int = 8192,
        device=None,
        stream: str = "philox",
    ):
        if not buckets or list(buckets) != sorted(set(int(b) for b in buckets)):
            raise ValueError(f"buckets must be a strictly increasing ladder, got {buckets!r}")
        self.device = resolve_device(device)
        self.K_max = int(K_max)
        self.k_cap = int(k_cap if k_cap is not None else max(8, K_max // 8))
        self.staleness = int(staleness)
        self.alpha = float(alpha)
        self.buckets = tuple(int(b) for b in buckets)
        self.n_iters, self.tile = int(n_iters), int(tile)
        J, dev = self.buckets[0], self.device
        cfg = MultiJobConfig(
            k=torch.ones((J,), dtype=torch.int32, device=dev),
            sigma=torch.zeros((J,), dtype=_f32, device=dev),
            eta=torch.zeros((J,), dtype=_f32, device=dev),
            active=torch.zeros((J, self.K_max), dtype=_f32, device=dev),
        )
        state = MultiJobState(logw=torch.zeros((J, self.K_max), dtype=_f32, device=dev),
                              t=torch.zeros((J,), dtype=torch.int32, device=dev))
        self._set_step(cfg, state, torch.zeros((J, self.staleness, self.K_max), dtype=_f32, device=dev))
        self.stream = _check_stream(stream)
        self.partitionable = default_partitionable()  # the JAX stream's threefry mode
        self.seeds = torch.zeros((J,), dtype=torch.int64)  # host: the noise is drawn from them on the host
        # the slots' PRNGKey(seed) words on the JAX stream, (J, 2) int32 on the device
        self.base_keys = torch.zeros((J, 2), dtype=torch.int32, device=dev)
        self._t = np.zeros((J,), np.int64)  # host mirror of the round counters
        self.jobs: Dict[int, dict] = {}  # uid -> {"slot": int, "spec": JobSpec}
        self._next_uid = 0
        self.faults = None  # chaos hook (repro_torch.serve.faults.FaultPlan) or None

    def _set_step(self, cfg, state, pending) -> None:
        self._step = _SlotStep(cfg, state, pending, self.k_cap, self.staleness, self.alpha, self.n_iters, self.tile)

    # the evolving state lives in the current step's buffers
    @property
    def cfg(self) -> MultiJobConfig:
        return self._step.cfg

    @property
    def state(self) -> MultiJobState:
        return self._step.state

    @property
    def pending(self) -> torch.Tensor:
        return self._step.pending

    # -- capacity ---------------------------------------------------------

    @property
    def n_slots(self) -> int:
        return self.cfg.active.shape[0]

    def _free_slot(self) -> int:
        used = {j["slot"] for j in self.jobs.values()}
        for s in range(self.n_slots):
            if s not in used:
                return s
        self._grow()
        return len(used)

    def _grow(self) -> None:
        ladder = [b for b in self.buckets if b > self.n_slots]
        if not ladder:
            raise CapacityError(
                f"all {self.n_slots} slots occupied and the bucket ladder {self.buckets} is exhausted"
            )
        new_J = ladder[0]
        pad = new_J - self.n_slots
        cfg, state = pad_slots(self.cfg, self.state, new_J)
        pending = torch.cat([self.pending, self.pending.new_zeros((pad, *self.pending.shape[1:]))])
        self._set_step(cfg, state, pending)  # the old bucket's graph goes with its step
        self.seeds = torch.cat([self.seeds, self.seeds.new_zeros(pad)])
        self.base_keys = torch.cat([self.base_keys, self.base_keys.new_zeros((pad, 2))])
        self._t = np.concatenate([self._t, np.zeros(pad, np.int64)])

    def _write_cfg(self, cfg: MultiJobConfig) -> None:
        for buf, v in zip(self.cfg, cfg):
            buf.copy_(v)

    # -- lifecycle --------------------------------------------------------

    def admit(self, spec: JobSpec) -> int:
        if spec.K > self.K_max:
            raise ValueError(f"job K={spec.K} exceeds the server's K_max={self.K_max}")
        if spec.k > self.k_cap:
            raise ValueError(f"job k={spec.k} exceeds the server's cohort cap k_cap={self.k_cap}")
        slot = self._free_slot()
        uid = self._next_uid
        self._next_uid += 1
        self._write_cfg(slot_admit(self.cfg, slot, spec.K, spec.k, spec.sigma_frac, spec.eta))
        self.state.logw[slot] = 0.0
        self.state.t[slot] = 0
        self.pending[slot] = 0.0
        self.seeds[slot] = int(spec.seed)
        self.base_keys[slot] = PRNGKey(spec.seed, self.device).data
        self._t[slot] = 0
        self.jobs[uid] = {"slot": slot, "spec": spec}
        return uid

    def retire(self, uid: int) -> None:
        job = self.jobs.pop(uid)
        self._write_cfg(slot_retire(self.cfg, job["slot"]))

    def job_round(self, uid: int) -> int:
        """The round the job's NEXT tick will serve (the idempotency cursor
        the transport's retry cache compares request rounds against)."""
        return int(self._t[self.jobs[uid]["slot"]])

    # -- the batched serving step ----------------------------------------

    def gumbel_row(self, seed: int, t: int) -> torch.Tensor:
        """Job round ``t``'s ``(K_max,)`` Gumbel row, from the job's seed and
        round alone: a generator seeded from ``SeedSequence([seed, t])``
        (``job_generator`` with the round in the stream's place).  The tests
        assign a function of ``(seed, t)`` on an instance to hand the engine
        other rows."""
        u = torch.rand(self.K_max, generator=job_generator(seed, t, self.device), device=self.device)
        return gumbel_from_uniform(u)

    def _draw_row(self, slot: int, out: torch.Tensor) -> None:
        """The slot's job's row of this tick into ``out``: on the JAX stream
        ``gumbel(fold_in(base_key, t), (K_max,))``, one threefry launch."""
        t = int(self._t[slot])
        if self.stream == "jax":
            gumbel(fold_in(Key(self.base_keys[slot], partitionable=self.partitionable), t), (self.K_max,), out=out)
        else:
            out.copy_(self.gumbel_row(int(self.seeds[slot]), t))

    def tick(self, items: List[Tuple[int, np.ndarray]]) -> Dict[int, dict]:
        """One batched dispatch: ``items`` maps job uid -> this round's lag
        codes ``(K_job,)`` (each uid at most once).  Returns per-uid results
        ``{"round", "cohort", "on_time", "stale"}``."""
        if self.faults is not None:
            self.faults.on_engine_step()
        J, K_max, step = self.n_slots, self.K_max, self._step
        if len({u for u, _ in items}) != len(items):
            raise ValueError("duplicate job uid in one batch (coalesce across dispatches)")
        participate = np.zeros((J,), bool)
        lag = np.zeros((J, K_max), np.int32)
        rows = []
        for uid, row in items:
            job = self.jobs[uid]
            slot, K = job["slot"], job["spec"].K
            row = np.asarray(row, np.int32).reshape(-1)
            if row.shape[0] != K:
                raise ValueError(f"job {uid}: feedback has {row.shape[0]} entries, K={K}")
            participate[slot] = True
            lag[slot, :K] = row
            rows.append(slot)
        for slot in rows:
            self._draw_row(slot, step.g[slot])
        step.lag.copy_(torch.from_numpy(lag))
        step.participate.copy_(torch.from_numpy(participate))
        step.run()
        out = step.out.cpu().numpy()  # the tick's one copy to the host: cohorts, credit, the guard
        if not out[-1]:
            raise NumericsError("selector update produced non-finite log-weights; update refused")
        idx = out[: J * self.k_cap].reshape(J, self.k_cap)
        on_time = out[J * self.k_cap: J * self.k_cap + J].view(np.float32)
        stale = out[J * self.k_cap + J: -1].view(np.float32)
        results = {}
        for uid, _ in items:
            slot = self.jobs[uid]["slot"]
            results[uid] = {
                "round": int(self._t[slot]),
                "cohort": idx[slot][idx[slot] >= 0].tolist(),
                "on_time": float(on_time[slot]),
                "stale": float(stale[slot]),
            }
        self._t[participate] += 1
        return results

    # -- checkpoint surface ----------------------------------------------

    def meta(self) -> dict:
        """The static half of a checkpoint: everything needed to rebuild an
        identically-shaped engine (``engine_from_meta``) before restoring
        the array state into it."""
        return {
            "kind": self.kind,
            "K_max": self.K_max,
            "k_cap": self.k_cap,
            "staleness": self.staleness,
            "alpha": self.alpha,
            "buckets": list(self.buckets),
            "n_iters": self.n_iters,
            "tile": self.tile,
            **_stream_meta(self.stream, self.partitionable),
            "n_slots": self.n_slots,
            "next_uid": self._next_uid,
            "jobs": [
                {"uid": uid, "slot": j["slot"], "spec": j["spec"].to_json()}
                for uid, j in sorted(self.jobs.items())
            ],
        }

    def _noise_array(self):
        """The noise's state: the jobs' seeds, or on the JAX stream the
        slots' base keys (JAX's ``base_keys``)."""
        return ("base_keys", self.base_keys) if self.stream == "jax" else ("seeds", self.seeds)

    def arrays(self) -> dict:
        """The evolving array state (the checkpoint payload): weights, round
        counters, the staleness ring and the noise's state (the jobs' seeds,
        or the slots' JAX base keys)."""
        name, noise = self._noise_array()
        return {"logw": self.state.logw, "t": self.state.t, "pending": self.pending, name: noise}

    def load_arrays(self, arrays) -> None:
        """Copy the tensors of an ``arrays()`` tree into the engine's buffers."""
        for buf, name in ((self.state.logw, "logw"), (self.state.t, "t"), (self.pending, "pending"),
                          self._noise_array()[::-1]):
            buf.copy_(arrays[name])
        self._t = self.state.t.cpu().numpy().astype(np.int64)

    @classmethod
    def from_meta(cls, meta: dict, device=None) -> "SlotEngine":
        with _meta_mode(meta):
            eng = cls(
                K_max=meta["K_max"], k_cap=meta["k_cap"], staleness=meta["staleness"], alpha=meta["alpha"],
                buckets=meta["buckets"], n_iters=meta["n_iters"], tile=meta["tile"], device=device,
                stream=meta.get("stream", "philox"),
            )
        while eng.n_slots < meta["n_slots"]:
            eng._grow()
        for row in meta["jobs"]:
            spec = JobSpec.from_json(row["spec"])
            eng._write_cfg(slot_admit(eng.cfg, row["slot"], spec.K, spec.k, spec.sigma_frac, spec.eta))
            eng.seeds[row["slot"]] = int(spec.seed)
            eng.base_keys[row["slot"]] = PRNGKey(spec.seed, eng.device).data
            eng.jobs[row["uid"]] = {"slot": row["slot"], "spec": spec}
        eng._next_uid = meta["next_uid"]
        return eng


# ---------------------------------------------------------------------------
# ShardedEngine: fleet-scale jobs, one RoundProgram each
# ---------------------------------------------------------------------------


class EngineSuperseded(RuntimeError):
    """A newer ``ShardedEngine`` was built on this D-rank group (a restore):
    the other ranks mirror it now, so the older engine takes no commands."""


class _Channel:
    """Rank 0's commands to the other ranks of a D-rank group, on a gloo
    group of its own (``dist.new_group(backend="gloo")``), so that commands
    and the tick's lag rows cross as host objects whatever the compute group
    is.

    The leader holds ``lock`` from a command's send until the command's last
    collective has returned, so no command starts before the one before it
    has ended on every rank, whichever thread sends them (a killed server's
    engine thread and the caller restoring a new engine).  ``epoch`` names
    the engine the followers mirror: building an engine takes the next one,
    and a command of an older engine raises ``EngineSuperseded`` unsent.
    Each command carries a sequence number, which the followers check."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo")
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.lock = threading.Lock()
        self.epoch = 0
        self.seq = 0

    def send(self, *cmd) -> None:
        self.seq += 1
        dist.broadcast_object_list([(self.seq, cmd)], src=0, group=self.group)

    def recv(self) -> tuple:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        (seq, cmd), self.seq = box[0], self.seq + 1
        if seq != self.seq:
            raise RuntimeError(f"rank {self.rank} expected command {self.seq}, got {seq}")
        return cmd

    def rows(self, flat: Optional[np.ndarray], n: int = 0) -> np.ndarray:
        """A tick's lag rows end to end: rank 0's ``flat``, ``n`` int32 codes."""
        buf = torch.from_numpy(flat) if self.rank == 0 else torch.empty(n, dtype=torch.int32)
        dist.broadcast(buf, src=0, group=self.group)
        return buf.numpy()

    def gather(self, obj):
        """Every rank's ``obj`` in rank order on rank 0 (None elsewhere)."""
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def scatter(self, objs):
        """Rank r's ``objs[r]`` (rank 0 holds the list)."""
        box = [None]
        dist.scatter_object_list(box, objs, src=0, group=self.group)
        return box[0]

    def close(self) -> None:
        """The end of the channel, on every rank after the ``stop`` command:
        the ranks meet on its group, so none tears its connections down
        while a peer still reads, then the group is destroyed now, while
        every peer is up and before the caller destroys the default group.
        A gloo group left to the interpreter's teardown (the module global
        below held it past ``destroy_process_group``) aborted a rank at exit
        now and then ("terminate called without an active exception")."""
        dist.barrier(group=self.group)
        dist.destroy_process_group(self.group)
        self.group = None
        if _CHANNEL[1] is self:
            _CHANNEL[:] = [None, None]


# the channel of the current default process group: one per group, made by
# every rank at the same point (new_group is collective): the leader's first
# D > 1 engine, a follower's ``follow``, or ``stop_followers``; the stop
# closes it on every rank, and the next engine makes a new one
_CHANNEL: list = [None, None]


def _channel() -> _Channel:
    if _CHANNEL[0] is not dist.group.WORLD:
        _CHANNEL[:] = [dist.group.WORLD, _Channel()]
    return _CHANNEL[1]


class ShardedEngine:
    """Each admitted job is one K-sharded ``RoundProgram`` stepped a round a
    tick (see the module docstring) over the caller's process group
    (``make_host_mesh(D)``).  ``staleness=S`` serves sharded-async rounds with
    the ``(S, K_pad/D)`` rings carried per job; ``feedback`` picks the
    selector policy (``"deadline"`` or ``"late_credit"``); ``stream`` the
    noise (module docstring: a job's Philox generator state, or its JAX
    key).  ``device=None`` is the rank's CUDA device.

    JAX's engine is one process driving D devices; the port runs one process
    a rank, so at D > 1 rank 0 leads and the other ranks follow
    (``follow``).  Rank 0 holds the engine, and the server in front of it;
    every operation that reaches a collective or builds per-rank state
    (building the engine, ``admit``, ``retire``, ``tick``, ``arrays``,
    ``load_arrays``, ``load_state``) is first broadcast, with a tick's lag
    rows, on the group's ``_Channel``, then run on every rank in the same
    order.  A tick commits on every rank or on none (the finite flag is
    reduced over the ranks before any rank assigns), and its results are
    global on rank 0: the cohort gathered from the ranks' slabs, ``on_time``
    and ``stale`` summed.  ``arrays()`` gathers whole ``K_pad``-wide arrays to
    rank 0's host, each rank's own generator state stacked ``(D, ...)`` beside
    the shared one; ``load_arrays`` scatters each rank its slab and its own
    state.  A checkpoint restores at its own D only.  ``stop_followers``
    ends the followers' loops.  A one-rank group (NCCL on the card) has no
    followers and sends nothing.
    """

    kind = "sharded"

    def __init__(
        self,
        D: Optional[int] = None,
        staleness: int = 0,
        alpha: float = 0.5,
        block: int = 4,
        feedback: str = "deadline",
        device=None,
        stream: str = "philox",
    ):
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(D, device=device)
        if mesh.rank != 0:
            raise ValueError(f"rank {mesh.rank} of a {mesh.size}-rank group follows rank 0's engine: call "
                             "repro_torch.serve.engines.follow() there")
        self._setup(mesh, dict(staleness=staleness, alpha=alpha, block=block, feedback=feedback,
                               stream=_check_stream(stream), partitionable=default_partitionable()))
        self._next_uid = 0
        self.faults = None  # chaos hook (repro_torch.serve.faults.FaultPlan) or None
        if self.D > 1:
            self._chan = _channel()
            with self._chan.lock:
                self._chan.epoch += 1
                self._epoch = self._chan.epoch
                self._chan.send("build", self._config())

    def _setup(self, mesh, config: dict) -> None:
        self.mesh, self.D, self.device = mesh, int(mesh.size), mesh.device
        self.staleness = int(config["staleness"])
        self.alpha = float(config["alpha"])
        self.block = int(config["block"])
        self.feedback = config["feedback"]
        self.stream = config["stream"]
        self.partitionable = config["partitionable"]  # the JAX stream's threefry mode
        self._runners: dict = {}  # geometry key -> (run, state0, program)
        self.jobs: Dict[int, dict] = {}
        self._chan: Optional[_Channel] = None
        self._epoch = None  # the leader's place in its channel's epochs

    def _config(self) -> dict:
        return dict(staleness=self.staleness, alpha=self.alpha, block=self.block, feedback=self.feedback,
                    stream=self.stream, partitionable=self.partitionable)

    @contextlib.contextmanager
    def _command(self, *cmd):
        """Run the body as ``cmd`` on every rank: at D > 1 send ``cmd`` to the
        followers first, holding the channel until the body returns."""
        if self._chan is None:
            yield
            return
        with self._chan.lock:
            if self._chan.epoch != self._epoch:
                raise EngineSuperseded("a newer engine leads this group; this one takes no more commands")
            self._chan.send(*cmd)
            yield

    def _runner(self, spec: JobSpec):
        from repro_torch.configs.base import FLConfig
        from repro_torch.engine.round_program import RoundProgram

        geom = (spec.K, spec.k, spec.rounds, spec.quota, spec.sigma_frac, spec.eta)
        hit = self._runners.get(geom)
        if hit is not None:
            return hit
        fl = FLConfig(
            K=spec.K, k=spec.k, rounds=spec.rounds, scheme="e3cs", quota=spec.quota,
            quota_frac=spec.sigma_frac, eta=spec.eta, allocator="bisect",
            staleness_rounds=self.staleness, staleness_alpha=self.alpha,
        )
        program = RoundProgram.from_config(fl, mesh=self.mesh, override="dense", feedback=self.feedback,
                                           block=self.block)
        run, state0 = program.build_runner(outputs="full", carry_key=True, scan_length=1)
        self._runners[geom] = (run, state0, program)
        return self._runners[geom]

    # -- lifecycle --------------------------------------------------------

    def admit(self, spec: JobSpec) -> int:
        # geometry bounds (k <= K_pad/D for the per-shard top-k) are enforced
        # by RoundProgram inside _runner, before any other rank hears of the job
        self._runner(spec)
        uid = self._next_uid
        with self._command("admit", uid, spec.to_json()):
            self._admit(uid, spec)
        self._next_uid += 1
        return uid

    def _admit(self, uid: int, spec: JobSpec) -> None:
        _, state0, program = self._runner(spec)
        self.jobs[uid] = {
            "spec": spec,
            "state": state0,
            "key": PRNGKey(spec.seed, self.device, self.partitionable) if self.stream == "jax"
            else program.generator(spec.seed).get_state(),
            "rings": program.init_rings() if self.staleness else (),
            "t": 0,
        }

    def retire(self, uid: int) -> None:
        if uid not in self.jobs:
            raise KeyError(uid)
        with self._command("retire", uid):
            del self.jobs[uid]

    def job_round(self, uid: int) -> int:
        """The round the job's NEXT tick will serve (the idempotency cursor
        the transport's retry cache compares request rounds against)."""
        return int(self.jobs[uid]["t"])

    # -- the serving step ---------------------------------------------------

    def tick(self, items: List[Tuple[int, np.ndarray]]) -> Dict[int, dict]:
        """Advance each job one round (one runner call a job: the K axis is
        the parallel one; there is no J axis to batch here)."""
        if self.faults is not None:
            self.faults.on_engine_step()  # a crash here reaches no other rank
        rows = []
        for uid, row in items:
            K = self.jobs[uid]["spec"].K
            row = np.asarray(row, np.int32).reshape(-1)
            if row.shape[0] != K:
                raise ValueError(f"job {uid}: feedback has {row.shape[0]} entries, K={K}")
            rows.append((uid, row))
        if not rows:
            return {}
        with self._command("tick", [uid for uid, _ in rows]):
            if self._chan is not None:
                self._chan.rows(np.concatenate([row for _, row in rows]))
            return self._tick(rows)

    def _tick(self, rows) -> Dict[int, dict]:
        """Every rank's side of a tick: the runner on the rank's slab of each
        job's row, then one ``psum`` of the finite flag, ``on_time`` and
        ``stale`` and one gather of the cohort."""
        S, results = self.staleness, {}
        for uid, row in rows:
            job = self.jobs[uid]
            spec: JobSpec = job["spec"]
            run, _, program = self._runner(spec)
            xs = program.local_rows(row[None, :] if S else (row == 0).astype(np.float32)[None, :])
            if S:
                state, key, rings, masks, _, _, _, arrived = run(job["state"], job["key"], job["rings"], xs)
                stale = torch.sum(arrived[0])
            else:
                state, key, masks, _, _, _ = run(job["state"], job["key"], xs)
                rings, stale = None, torch.zeros((), dtype=_f32, device=self.device)
            mask = masks[0]
            on_time = torch.sum(mask * (xs[0] == 0 if S else xs[0]))
            # the NaN/inf guard: the runner hands back new tensors, so the
            # job's state is intact; a non-finite weight on any rank refuses
            # the update on every rank before any assigns
            bad = torch.any(~torch.isfinite(state.e3cs.logw)).to(_f32)
            bad, on_time, stale = self.mesh.psum(torch.stack([bad, on_time, stale])).tolist()
            if bad:
                raise NumericsError(f"job {uid}: selector update produced non-finite log-weights; update refused")
            if rings is not None:
                job["rings"] = rings
            job["state"], job["key"] = state, key
            results[uid] = {"round": job["t"], "cohort": self._cohort(mask, spec.k), "on_time": on_time,
                            "stale": stale}
            job["t"] += 1
        return results

    def _cohort(self, mask: torch.Tensor, k: int) -> List[int]:
        """The round's cohort, ascending global client ids: each rank's
        selected slab positions, padded to ``k`` with -1, gathered in rank
        order."""
        loc = torch.nonzero(mask > 0).flatten()
        ids = torch.full((k,), -1, dtype=torch.int64, device=mask.device)
        ids[: loc.numel()] = loc + self.mesh.rank * mask.shape[0]
        ids = self.mesh.all_gather(ids)
        return ids[ids >= 0].tolist()

    # -- checkpoint surface ----------------------------------------------

    def meta(self) -> dict:
        return {
            "kind": self.kind,
            "D": self.D,
            "staleness": self.staleness,
            "alpha": self.alpha,
            "block": self.block,
            "feedback": self.feedback,
            **_stream_meta(self.stream, self.partitionable),
            "next_uid": self._next_uid,
            "jobs": [
                {"uid": uid, "t": j["t"], "spec": j["spec"].to_json()}
                for uid, j in sorted(self.jobs.items())
            ],
        }

    def _key_array(self, key):
        """A job's noise state as a checkpoint leaf: the JAX key's words, or
        the generator state."""
        return key.data if self.stream == "jax" else key

    def _key_of(self, a):
        return Key(a.to(self.device), partitionable=self.partitionable) if self.stream == "jax" else a

    def arrays(self) -> dict:
        """Per-job evolving state keyed by uid (string keys, in uid order):
        the full ``ServerState``, the generator state (or the JAX key's
        ``(2,)`` words), and the staleness / late-credit rings.  At D > 1 the
        arrays are whole (``K_pad`` wide, on the host) and the generator
        state is ``(own, shared)``, ``own`` the ranks' own streams stacked
        ``(D, ...)``; a JAX key is the same on every rank."""
        if self.D == 1:
            return {
                str(uid): {"state": j["state"], "key": self._key_array(j["key"]), "rings": list(j["rings"])}
                for uid, j in sorted(self.jobs.items())
            }
        with self._command("arrays"):
            return self._gather()

    def _gather(self) -> Optional[dict]:
        from repro_torch.convert import join_slabs, state_from_jax, state_to_numpy

        jax_key = self.stream == "jax"
        parts = self._chan.gather({
            uid: {"named": state_to_numpy(j["state"], j["rings"]),
                  **({"key": j["key"].data.cpu()} if jax_key else {"own": j["key"][0], "shared": j["key"][1]})}
            for uid, j in sorted(self.jobs.items())
        })
        if parts is None:  # a follower
            return None
        out = {}
        for uid in sorted(self.jobs):
            slabs = [p[uid] for p in parts]
            state, rings = state_from_jax(join_slabs([s["named"] for s in slabs]), device="cpu")
            key = slabs[0]["key"] if jax_key else (torch.stack([s["own"] for s in slabs]), slabs[0]["shared"])
            out[str(uid)] = {"state": state, "key": key, "rings": list(rings)}
        return out

    def load_arrays(self, arrays) -> None:
        if self.D == 1:
            for uid, job in self.jobs.items():
                blob = arrays[str(uid)]
                job["state"], job["key"], job["rings"] = blob["state"], self._key_of(blob["key"]), tuple(blob["rings"])
            return
        from repro_torch.convert import state_to_numpy

        named, keys = {}, {}
        for uid in self.jobs:
            blob = arrays[str(uid)]
            named[uid], keys[uid] = state_to_numpy(blob["state"], tuple(blob["rings"])), blob["key"]
        self._scatter(named, keys)

    def load_state(self, uid: int, named: Dict[str, np.ndarray], key: Optional[torch.Tensor] = None) -> None:
        """Job ``uid``'s state and rings from ``K_pad``-wide numpy arrays under
        ``repro_torch.convert``'s names (a JAX job's, ``sharded_job_from_jax``);
        at D > 1 each rank takes its slab.  ``key``, a JAX key's ``(2,)``
        int32 words, replaces the job's key on the JAX stream; otherwise the
        noise state stays."""
        from repro_torch.convert import state_from_jax

        if key is not None and self.stream != "jax":
            raise ValueError("a JAX key continues only on an engine of stream='jax'")
        if self.D == 1:
            job = self.jobs[uid]
            job["state"], job["rings"] = state_from_jax(named, device=self.device)
            if key is not None:
                job["key"] = self._key_of(key)
            return
        if uid not in self.jobs:
            raise KeyError(uid)
        self._scatter({uid: named}, {} if key is None else {uid: key})

    def _scatter(self, named: dict, keys: dict) -> None:
        """Send each rank its slab of each job's named arrays and, where
        ``keys`` holds the job's ``(own (D, ...), shared)``, its streams."""
        from repro_torch.convert import shard_arrays

        per_rank = []
        for r in range(self.D):
            mine = {}
            for uid, arrs in named.items():
                mine[uid] = {"named": shard_arrays(arrs, r, self.D)}
                if uid in keys and self.stream == "jax":
                    mine[uid]["key"] = keys[uid].cpu()
                elif uid in keys:
                    mine[uid].update(own=keys[uid][0][r].clone(), shared=keys[uid][1])
            per_rank.append(mine)
        with self._command("load"):
            self._load(self._chan.scatter(per_rank))

    def _load(self, slabs: dict) -> None:
        from repro_torch.convert import state_from_jax

        for uid, blob in slabs.items():
            job = self.jobs[uid]
            job["state"], job["rings"] = state_from_jax(blob["named"], device=self.device)
            if "own" in blob:
                job["key"] = (blob["own"], blob["shared"])
            elif "key" in blob:
                job["key"] = self._key_of(blob["key"])

    @classmethod
    def from_meta(cls, meta: dict, device=None) -> "ShardedEngine":
        with _meta_mode(meta):
            eng = cls(
                D=meta["D"], staleness=meta["staleness"], alpha=meta["alpha"], block=meta["block"],
                feedback=meta["feedback"], device=device, stream=meta.get("stream", "philox"),
            )
        for row in meta["jobs"]:
            eng._next_uid = row["uid"]  # admit under the job's own uid
            eng.admit(JobSpec.from_json(row["spec"]))
            eng.jobs[row["uid"]]["t"] = row["t"]
        eng._next_uid = meta["next_uid"]
        return eng

    # -- the followers ------------------------------------------------------

    def _follow(self, op: str, *args) -> None:
        """A follower's side of the leader's command ``op``."""
        if op == "admit":
            self._admit(args[0], JobSpec.from_json(args[1]))
        elif op == "retire":
            del self.jobs[args[0]]
        elif op == "tick":
            Ks = [self.jobs[uid]["spec"].K for uid in args[0]]
            rows = np.split(self._chan.rows(None, sum(Ks)), np.cumsum(Ks)[:-1])
            self._tick(list(zip(args[0], rows)))
        elif op == "arrays":
            self._gather()
        elif op == "load":
            self._load(self._chan.scatter(None))
        else:
            raise ValueError(f"unknown engine command {op!r}")


def follow(D: Optional[int] = None, device=None) -> Optional[ShardedEngine]:
    """Rank r > 0's side of a D-rank ``ShardedEngine``: mirror every engine
    rank 0 builds on the group (each build replaces the last), one command
    at a time, until rank 0 calls ``stop_followers``; returns the last
    engine.  A tick refused for a non-finite weight is refused on rank 0
    too, from the same reduced flag, and the loop goes on.  ``device=None``
    is the rank's CUDA device."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(D, device=device)
    if mesh.rank == 0:
        raise ValueError("rank 0 leads: it builds the ShardedEngine (and serves it); the other ranks follow")
    chan, eng = _channel(), None
    while True:
        op, *args = chan.recv()
        if op == "stop":
            chan.close()
            return eng
        if op == "build":
            eng = None  # the replaced engine's buffers go before the new one's
            eng = ShardedEngine.__new__(ShardedEngine)
            eng._setup(mesh, args[0])
            eng._chan = chan
            continue
        try:
            eng._follow(op, *args)
        except NumericsError:
            pass


def stop_followers() -> None:
    """Rank 0: end the followers' ``follow`` loops on the default process
    group (a group of one rank has none) and close the control channel on
    every rank (``_Channel.close``).  Every engine built before is
    superseded."""
    if dist.get_world_size() == 1:
        return
    chan = _channel()
    with chan.lock:
        chan.epoch += 1
        chan.send("stop")
        chan.close()


def engine_from_meta(meta: dict, device=None):
    """Rebuild an engine shell from its checkpoint meta (static config and
    job table) on ``device`` (``None``: CUDA); the caller then restores the
    array state into it (``repro_torch.serve.state.load_server`` does
    both)."""
    kinds = {SlotEngine.kind: SlotEngine, ShardedEngine.kind: ShardedEngine}
    kind = meta.get("kind")
    if kind not in kinds:
        raise ValueError(f"unknown engine kind {kind!r} (want one of {sorted(kinds)})")
    return kinds[kind].from_meta(meta, device=device)

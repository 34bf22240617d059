"""The serving front end: socket transport + streaming batcher + restart
(the port of ``repro.serve.transport``: the same wire contract, job
lifecycle and error codes).

``SelectionServer`` puts a request/response loop in front of a serving
engine (``repro_torch.serve.engines``).  The moving parts:

* **connection handlers** — one thread per accepted connection, each running
  a strict request → response loop over the length-prefixed frames of
  ``repro_torch.serve.protocol``.  Handlers never touch the engine: they
  parse, enqueue, and wait.
* **the streaming batcher** — ONE engine thread owns the engine and runs
  all of its device work (captures, replays, the sharded engine's
  collectives).  It drains
  the admission queue, coalescing consecutive ``tick`` requests from
  *different* jobs into a single batched dispatch (the slot engine turns
  J waiting tenants into one graph replay).  A duplicate job, a
  control op (admit/retire/checkpoint), or an empty queue closes the batch.
  Per-job ordering is preserved; co-tenancy never changes any job's
  results (engine noise is per job).
* **the supervisor** — the engine thread runs under a restart loop.  A
  crashed engine step (a fault-injected :class:`~repro_torch.serve.faults.EngineCrash`
  or any unexpected exception) fails the in-flight requests with
  ``error: "retry"``, then the supervisor restores the engine from the
  newest *valid* checkpoint (``latest_server_checkpoint`` walks back past
  corrupt stems), with exponential backoff on repeated restarts and a
  ``max_restarts`` budget — past it the server answers ``engine_down``.
  The restored engine replaces the crashed one, which is left unreachable
  (the crash's traceback is dropped first), so its buffers and captured
  graphs are freed as the new engine takes over.
  Each restart sets the ``degraded`` stat flag (cleared by the next clean
  dispatch), appends an ``engine_restart`` alert, and lands in the
  ``restarts`` / ``recovery_s`` gauges of the ``serve`` tap group.
* **idempotent ticks** — a ``tick`` may carry the client's ``round``.  The
  server keeps a small per-job last-response cache: a replayed round
  returns the cached cohort instead of double-applying feedback (the
  property that makes client retries safe), and a request whose round
  disagrees with the engine's cursor fails with ``round_desync`` carrying
  the ``expected`` round so the client can rewind and replay.
* **backpressure** — the queue is bounded (``max_queue``); when it is full
  new requests are **shed** immediately with ``error: "shed"`` rather than
  queued into unbounded latency.  Shed counts are reported per tick through
  the ``serve`` tap group.
* **timeouts** — every queued request carries a deadline
  (``request_timeout`` seconds); if the engine thread dequeues it too late
  the request fails with ``error: "timeout"`` instead of being executed —
  the engine never spends device time on an answer nobody is waiting for.
* **elastic restart** — with ``ckpt_dir`` set, the engine thread snapshots
  the full engine state (``repro_torch.serve.state.save_server``) every
  ``ckpt_every`` served rounds and on graceful shutdown, pruning to the
  newest ``ckpt_keep`` stems.  A new server started from ``load_server``
  continues bit-identically.
* **graceful drain** — ``close()`` (or a ``shutdown`` request) stops
  admissions, answers everything already queued, checkpoints, then exits.
  A join that times out is surfaced (``hung_engine`` stat + log line), not
  silently leaked.  ``kill()`` is the crash path for restart tests: drops
  everything on the floor, no final checkpoint.
* **chaos** — ``faults=FaultPlan(...)`` injects the seeded fault schedule
  (engine crashes, checkpoint corruption, dropped responses, slow
  dispatches) of ``repro_torch.serve.faults``; None (the default) leaves every
  hook a no-op.

Per-dispatch telemetry (queue depth, batch width, sheds, restarts and
recovery latency — the ``serve`` group of ``ROUND_TAPS``) and a
dispatch-latency ``LatencyHistogram`` accumulate on the server;
``attach_report`` hands them to a ``Reporter`` so server runs land in bench
JSON / run logs like any engine run.
"""
from __future__ import annotations

import logging
import queue
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import ROUND_TAPS, LatencyHistogram
from repro_torch.obs.alerts import Alert, log_alerts

from . import protocol
from .engines import CapacityError, JobSpec, NumericsError
from .state import latest_server_checkpoint, load_server, save_server

__all__ = ["SelectionServer", "SERVE_WINDOW"]

SERVE_WINDOW = 16  # ticks per telemetry window when attaching to a Reporter

log = logging.getLogger("repro_torch.serve")


class _Item:
    """One queued request: parsed op + the handler's rendezvous."""

    __slots__ = ("req", "deadline", "event", "response")

    def __init__(self, req: dict, deadline: float):
        self.req = req
        self.deadline = deadline
        self.event = threading.Event()
        self.response: Optional[dict] = None

    def respond(self, resp: dict) -> None:
        self.response = resp
        self.event.set()


def _err(code: str, message: str, **extra) -> dict:
    return {"ok": False, "error": code, "message": message, **extra}


class SelectionServer:
    """Serve one engine over a loopback/LAN socket (see module docstring).

    ``port=0`` binds an ephemeral port — read it back from ``address`` after
    ``start()``.  The server is also a context manager (``with`` = start /
    graceful close).
    """

    def __init__(
        self,
        engine,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        max_queue: int = 64,
        max_batch: int = 0,
        request_timeout: float = 30.0,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 0,
        ckpt_keep: int = 0,
        faults=None,
        max_restarts: int = 8,
        restart_backoff: float = 0.05,
        stop_timeout: float = 60.0,
    ):
        self.engine = engine
        self._host, self._port = host, int(port)
        self.max_queue = int(max_queue)
        self.max_batch = int(max_batch)  # 0 = no cap beyond queue coalescing
        self.request_timeout = float(request_timeout)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self.ckpt_keep = int(ckpt_keep)
        self.faults = faults
        if faults is not None:
            engine.faults = faults
        self.max_restarts = int(max_restarts)
        self.restart_backoff = float(restart_backoff)
        self.stop_timeout = float(stop_timeout)
        self._queue: "queue.Queue[_Item]" = queue.Queue(maxsize=self.max_queue)
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._engine_dead = threading.Event()  # restart budget exhausted
        self._lock = threading.Lock()  # connection set + stats
        self._conns: set = set()
        self._threads: List[threading.Thread] = []
        self._listener: Optional[socket.socket] = None
        self.stats: Dict[str, int] = {
            "admitted": 0, "retired": 0, "ticks": 0, "dispatches": 0,
            "shed": 0, "timeouts": 0, "errors": 0, "checkpoints": 0,
            "restarts": 0, "degraded": 0, "hung_engine": 0,
            "numerics": 0, "replayed": 0,
        }
        self._shed_window = 0  # sheds since the last dispatch row
        self._restart_window = 0  # restarts since the last dispatch row
        self._recovery_window = 0.0  # recovery seconds since the last dispatch row
        self._rounds_since_ckpt = 0
        self.rounds_served = 0
        self.serve_rows: List[Dict[str, float]] = []
        self.latency = LatencyHistogram(lo=1e-5, hi=60.0)
        self.recoveries: List[float] = []  # crash-to-restored latencies (s)
        self.alerts: List[Alert] = []  # engine_restart / numerics events
        self._tick_cache: Dict[int, Tuple[int, dict]] = {}  # uid -> (round, response)
        self.last_checkpoint: Optional[str] = None
        self._final_checkpoint = True  # kill() / close(checkpoint=False) clear it

    # -- lifecycle ---------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        return self._host, self._port

    def start(self) -> "SelectionServer":
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lst.bind((self._host, self._port))
        self._port = lst.getsockname()[1]
        lst.listen(32)
        lst.settimeout(0.2)
        self._listener = lst
        for target, name in ((self._accept_loop, "serve-accept"), (self._engine_loop, "serve-engine")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def close(self, checkpoint: bool = True) -> None:
        """Graceful drain: stop admitting, answer the queue, optionally
        write a final checkpoint, then tear the sockets down.  A thread that
        outlives ``stop_timeout`` is surfaced — ``hung_engine`` stat + log
        line — instead of being silently leaked."""
        if self._stopped.is_set():
            return
        self._final_checkpoint = bool(checkpoint)
        self._draining.set()
        self._post_stop()
        for t in self._threads:
            t.join(timeout=self.stop_timeout)
        hung = [t.name for t in self._threads if t.is_alive()]
        if hung:
            with self._lock:
                self.stats["hung_engine"] = 1
            log.error(
                "close(): %s did not stop within %.1fs — thread leaked, "
                "final checkpoint may be missing", ", ".join(hung), self.stop_timeout,
            )
        self._teardown()

    def kill(self) -> None:
        """Crash path (for restart tests): no drain, no final checkpoint —
        queued requests and un-checkpointed state are lost, exactly like a
        process kill."""
        self._final_checkpoint = False
        self._draining.set()
        self._stopped.set()
        self._post_stop()
        self._teardown()

    def _post_stop(self) -> None:
        """Deliver the engine-thread stop sentinel without deadlocking on a
        full queue (the engine drains it; if the thread is already gone the
        sentinel is moot)."""
        try:
            self._queue.put(_Item({"op": "_stop"}, float("inf")), timeout=5.0)
        except queue.Full:
            pass

    def _teardown(self) -> None:
        self._stopped.set()
        if self._listener is not None:
            self._listener.close()
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()

    def __enter__(self) -> "SelectionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- socket side -------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._draining.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._handle, args=(conn,), daemon=True)
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        """One connection's request → response loop; parse errors poison the
        stream (respond once, then hang up).  The chaos hook may cut the
        connection instead of sending a response — the request already
        executed, exactly like a network failure between server and client
        (the idempotent tick cache is what makes the client's retry safe)."""
        try:
            while not self._stopped.is_set():
                try:
                    req = protocol.recv_message(conn)
                except protocol.ConnectionClosed:
                    break
                except protocol.ProtocolError as e:
                    protocol.send_message(conn, _err("bad_request", str(e)))
                    break
                resp = self._submit(req)
                if self.faults is not None and self.faults.on_response():
                    break  # fault-injected connection drop: response lost
                protocol.send_message(conn, resp)
                if req.get("op") == "shutdown":
                    break
        except OSError:
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)
            conn.close()

    def _submit(self, req: dict) -> dict:
        """Admission control: queue the request for the engine thread and
        wait for its response (shed instead of queueing when full)."""
        if self._engine_dead.is_set():
            return _err("engine_down", "engine restart budget exhausted; server needs operator attention")
        if self._draining.is_set():
            return _err("draining", "server is draining; no new requests")
        item = _Item(req, time.monotonic() + self.request_timeout)
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            with self._lock:
                self.stats["shed"] += 1
                self._shed_window += 1
            return _err("shed", f"admission queue at capacity ({self.max_queue})")
        # The engine thread guarantees a response for every queued item; the
        # extra margin only matters if it died mid-request.
        if not item.event.wait(self.request_timeout * 2 + 60.0):
            return _err("internal", "engine thread unresponsive")
        return item.response

    # -- engine side -------------------------------------------------------

    def _engine_loop(self) -> None:
        """The supervisor: run the batcher; on a crashed engine step restore
        from the newest valid checkpoint and keep serving.  In-flight
        requests were already failed with ``retry`` by ``_dispatch``; past
        the restart budget the queue is failed with ``engine_down`` and the
        server stays up only to answer that."""
        while True:
            try:
                self._engine_run()
                return
            except Exception as e:
                if self._stopped.is_set():
                    return
                if not self._recover(e):
                    self._engine_dead.set()
                    self._fail_pending("engine_down", "engine restart budget exhausted")
                    return
                if self._draining.is_set():
                    # the stop sentinel may already be consumed — finish the
                    # drain the crashed loop was (or would be) running
                    try:
                        self._drain_queue()
                        if self._final_checkpoint and self.ckpt_dir:
                            self._checkpoint()
                        return
                    except Exception as e2:  # crashed again mid-drain
                        if not self._recover(e2):
                            self._engine_dead.set()
                            self._fail_pending("engine_down", "engine restart budget exhausted")
                            return

    def _recover(self, exc: BaseException) -> bool:
        """One supervised restart: backoff, restore the engine from the
        newest *valid* checkpoint (walk-back skips corrupt stems), roll the
        served-round cursor back to the restore point and invalidate the
        tick cache.  Without a restorable checkpoint the in-memory engine
        carries on (the crash happened before any state mutated).  Returns
        False when the restart budget is exhausted."""
        # the traceback holds the crashed engine's frames: drop it, so the
        # old engine goes the moment the restored one replaces it
        exc.__traceback__ = None
        t0 = time.monotonic()
        with self._lock:
            self.stats["restarts"] += 1
            self.stats["degraded"] = 1
            n = self.stats["restarts"]
        if n > self.max_restarts:
            log.error("engine crashed (%s) and the restart budget (%d) is exhausted", exc, self.max_restarts)
            return False
        time.sleep(min(1.0, self.restart_backoff * (2 ** (n - 1))))
        stem = latest_server_checkpoint(self.ckpt_dir) if self.ckpt_dir else None
        restored_step = None
        if stem is not None:
            engine, step = load_server(stem, device=self.engine.device)
            if self.faults is not None:
                engine.faults = self.faults
            self.engine = engine
            self.rounds_served = restored_step = step
            self._rounds_since_ckpt = 0
        self._tick_cache.clear()
        dt = time.monotonic() - t0
        self.recoveries.append(dt)
        with self._lock:
            self._restart_window += 1
            self._recovery_window += dt
        self.alerts.append(Alert(
            "engine_restart", "critical",
            {"restart": n, "recovery_s": dt, "restored_step": restored_step,
             "checkpoint": stem, "error": repr(exc)},
            f"engine crashed ({exc}); restart {n}/{self.max_restarts} "
            + (f"restored step {restored_step} from {stem}" if stem else "continuing in-memory"),
        ))
        log.warning("engine restart %d/%d after %r: %s in %.3fs", n, self.max_restarts, exc,
                    f"restored step {restored_step}" if stem else "no valid checkpoint", dt)
        return True

    def _fail_pending(self, code: str, message: str) -> None:
        """Answer everything queued with an error (the engine is gone)."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item.req.get("op") != "_stop":
                item.respond(_err(code, message))

    def _engine_run(self) -> None:
        while True:
            try:
                item = self._queue.get()
            except Exception:
                break
            batch: List[_Item] = []
            uids = set()
            stop = False
            while True:
                op = item.req.get("op")
                if op == "_stop":
                    stop = True
                    break
                if op == "tick":
                    uid = item.req.get("job")
                    if uid in uids:  # same job twice: preserve per-job order
                        self._dispatch(batch)
                        batch, uids = [], set()
                    batch.append(item)
                    uids.add(uid)
                    if self.max_batch and len(batch) >= self.max_batch:
                        self._dispatch(batch)
                        batch, uids = [], set()
                else:
                    try:
                        self._dispatch(batch)  # control ops serialize with ticks
                    except Exception:
                        # the crash must not strand the waiting control item
                        item.respond(_err("retry", "engine crashed before this request; retry"))
                        raise
                    batch, uids = [], set()
                    item.respond(self._control(item.req))
                    if op == "shutdown":  # remote shutdown == graceful drain
                        stop = True
                        break
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
            self._dispatch(batch)
            if stop:
                self._drain_queue()
                if self._final_checkpoint and self.ckpt_dir:
                    self._checkpoint()
                return

    def _drain_queue(self) -> None:
        """Answer everything still queued at shutdown (graceful drain)."""
        batch: List[_Item] = []
        uids = set()
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            op = item.req.get("op")
            if op == "_stop":
                continue
            if op == "tick":
                if item.req.get("job") in uids:
                    self._dispatch(batch)
                    batch, uids = [], set()
                batch.append(item)
                uids.add(item.req.get("job"))
            else:
                try:
                    self._dispatch(batch)
                except Exception:
                    item.respond(_err("retry", "engine crashed before this request; retry"))
                    raise
                batch, uids = [], set()
                item.respond(self._control(item.req))
        self._dispatch(batch)

    def _dispatch(self, batch: List[_Item]) -> None:
        """One batched engine tick for the coalesced requests.

        Requests carrying a ``round`` go through the idempotency check
        first: a replay of the engine's last-served round for that job is
        answered from the per-job response cache (feedback is NOT
        re-applied); any other disagreement with the engine's cursor fails
        with ``round_desync`` + the ``expected`` round.  An engine crash
        fails the in-flight requests with ``retry`` and re-raises to the
        supervisor; a refused non-finite update fails them with
        ``numerics`` and raises an alert, engine state untouched.
        """
        if not batch:
            return
        now = time.monotonic()
        live: List[_Item] = []
        items: List[Tuple[int, np.ndarray]] = []
        for item in batch:
            if now > item.deadline:
                with self._lock:
                    self.stats["timeouts"] += 1
                item.respond(_err("timeout", "request expired before dispatch"))
                continue
            uid = item.req.get("job")
            job = self.engine.jobs.get(uid)
            if job is None:
                item.respond(_err("unknown_job", f"no job {uid!r}"))
                continue
            r = item.req.get("round")
            if r is not None:
                # cursor = last served round + 1, read from the host-side
                # response cache — engine.job_round pulls a device scalar,
                # too slow for the per-tick hot path.  Cold cache (first
                # tick after admit, restore or a supervised recovery) is
                # exactly when the engine must be asked.
                cached = self._tick_cache.get(uid)
                cur = cached[0] + 1 if cached is not None else self.engine.job_round(uid)
                if int(r) != cur:
                    if cached is not None and cached[0] == int(r):
                        with self._lock:
                            self.stats["replayed"] += 1
                        item.respond(cached[1])
                        continue
                    item.respond(_err(
                        "round_desync",
                        f"job {uid} is at round {cur}, request carries round {r} "
                        "(replay from the expected round)",
                        expected=cur,
                    ))
                    continue
            spec: JobSpec = job["spec"]
            try:
                lag = protocol.feedback_lags(item.req, spec.K, self.engine.staleness)
            except protocol.ProtocolError as e:
                item.respond(_err("bad_request", str(e)))
                continue
            if lag is None:
                item.respond(_err("bad_request", "tick carries no feedback (x/xb/xl)"))
                continue
            live.append(item)
            items.append((uid, lag))
        if not items:
            return
        t0 = time.perf_counter()
        try:
            results = self.engine.tick(items)
        except (ValueError, TypeError, KeyError) as e:  # rejected batch: fail its requests
            with self._lock:
                self.stats["errors"] += len(live)
            for item in live:
                item.respond(_err("bad_request", str(e)))
            return
        except NumericsError as e:  # update refused, state intact: alert + fail
            with self._lock:
                self.stats["numerics"] += 1
                self.stats["errors"] += len(live)
            self.alerts.append(Alert(
                "numerics", "critical",
                {"dispatch": self.stats["dispatches"], "jobs": [u for u, _ in items]},
                str(e),
            ))
            log.error("non-finite selector update refused: %s", e)
            for item in live:
                item.respond(_err("numerics", str(e)))
            return
        except Exception as e:  # engine crashed: fail in-flight, wake the supervisor
            for item in live:
                item.respond(_err("retry", f"engine crashed mid-dispatch ({e}); retry"))
            raise
        self.latency.observe(time.perf_counter() - t0)
        with self._lock:
            self.stats["dispatches"] += 1
            self.stats["ticks"] += len(items)
            self.stats["degraded"] = 0  # a clean dispatch ends the degraded window
            shed = self._shed_window
            restarts = self._restart_window
            recovery = self._recovery_window
            self._shed_window = 0
            self._restart_window = 0
            self._recovery_window = 0.0
        self.serve_rows.append(
            {
                "queue_depth": float(self._queue.qsize()),
                "batch_jobs": float(len(items)),
                "shed": float(shed),
                "restarts": float(restarts),
                "recovery_s": float(recovery),
            }
        )
        self.rounds_served += len(items)
        self._rounds_since_ckpt += len(items)
        for item in live:
            resp = {"ok": True, **results[item.req["job"]]}
            self._tick_cache[item.req["job"]] = (resp["round"], resp)
            item.respond(resp)
        if (
            self.ckpt_dir
            and self.ckpt_every
            and self._rounds_since_ckpt >= self.ckpt_every
        ):
            self._checkpoint()

    def _control(self, req: dict) -> dict:
        """Admit/retire/checkpoint/info ops — engine-thread only, so they
        serialize with dispatches and mutate the engine race-free."""
        op = req.get("op")
        try:
            if op == "hello":
                return {
                    "ok": True,
                    "server": "repro-serve",
                    "engine": self.engine.kind,
                    "staleness": self.engine.staleness,
                    "jobs": len(self.engine.jobs),
                }
            if op == "admit":
                spec = JobSpec.from_json(req.get("spec") or {})
                uid = self.engine.admit(spec)
                with self._lock:
                    self.stats["admitted"] += 1
                return {"ok": True, "job": uid}
            if op == "retire":
                uid = req.get("job")
                if uid not in self.engine.jobs:
                    return _err("unknown_job", f"no job {uid!r}")
                self.engine.retire(uid)
                self._tick_cache.pop(uid, None)
                with self._lock:
                    self.stats["retired"] += 1
                return {"ok": True}
            if op == "stats":
                with self._lock:
                    stats = dict(self.stats)
                return {"ok": True, "stats": stats, "rounds_served": self.rounds_served}
            if op == "checkpoint":
                if not self.ckpt_dir:
                    return _err("bad_request", "server has no ckpt_dir")
                return {"ok": True, "path": self._checkpoint()}
            if op == "shutdown":
                self._draining.set()
                return {"ok": True, "message": "draining"}
            return _err("bad_request", f"unknown op {op!r}")
        except CapacityError as e:
            with self._lock:
                self.stats["shed"] += 1
                self._shed_window += 1
            return _err("capacity", str(e))
        except (ValueError, TypeError, KeyError) as e:
            with self._lock:
                self.stats["errors"] += 1
            return _err("bad_request", str(e))

    def _checkpoint(self) -> str:
        stem = save_server(
            self.ckpt_dir, self.engine, step=self.rounds_served,
            keep=self.ckpt_keep, faults=self.faults,
        )
        self._rounds_since_ckpt = 0
        self.last_checkpoint = stem
        with self._lock:
            self.stats["checkpoints"] += 1
        return stem

    # -- telemetry ---------------------------------------------------------

    def serve_series(self) -> Dict[str, np.ndarray]:
        """Per-dispatch gauge rows as arrays, keyed by the ``serve`` tap
        group schema."""
        names = ROUND_TAPS.gauge_names("serve")
        rows = self.serve_rows
        return {n: np.asarray([r[n] for r in rows], np.float64) for n in names}

    def attach_report(self, reporter, window: int = SERVE_WINDOW) -> None:
        """Emit this server's run into a ``Reporter``: the windowed ``serve``
        metric stream (gated by the tap group's directions) + the dispatch
        latency histogram + scalar stats."""
        if len(self.serve_rows) >= window:
            reporter.metrics_stream(
                "serve", self.serve_series(), window=window,
                better=ROUND_TAPS.directions("serve"),
            )
        reporter.histogram("dispatch", self.latency)
        reporter.update(rounds_served=self.rounds_served, **{f"n_{k}": v for k, v in self.stats.items()})
        if self.alerts:  # supervisor events (engine_restart / numerics)
            if reporter.log is not None:
                log_alerts(reporter.log, self.alerts)
            reporter.data.setdefault("alerts", []).extend(
                {"rule": a.rule, "severity": a.severity, "message": a.message, **a.detail}
                for a in self.alerts
            )

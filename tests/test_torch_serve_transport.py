"""The port's serving front end (``repro_torch.serve.SelectionServer``) over
loopback: the counterpart of every transport behaviour the JAX package pins
in ``tests/test_serve.py``, and wire compatibility in both directions.

* **Wire compatibility.** JAX's ``ServeClient`` drives the port's server and
  the port's client drives JAX's server: with the port's engine handed JAX's
  Gumbel rows, both servers answer the same requests with the same
  responses.
* **Transport.** Round trip and errors, concurrent batching, shed, timeout,
  drain with a final checkpoint, requests rejected while draining, the three
  fuzz cases, walk-back and retention, idempotent replay and
  ``round_desync``, client retries through dropped responses, the numerics
  guard, ``close`` surfacing a hung engine, supervisor restart (the crashed
  engine left unreachable, no collection needed) and ``engine_down`` once
  the restart budget is spent.

Every client, socket, join and wait has its own timeout.
"""
import gc
import json
import os
import socket
import struct
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import SelectionServer as JSelectionServer
from repro.serve import ServeClient as JServeClient
from repro.serve import SlotEngine as JSlotEngine
from repro_torch.serve import FaultPlan, JobSpec, SelectionServer, ServeClient, ServeError, SlotEngine
from repro_torch.serve import latest_server_checkpoint, load_server, protocol, save_server, validate_stem

TIMEOUT = 30.0  # every client socket, join and wait


def _lags(rng, K, S=2):
    lag = rng.integers(0, S + 2, K).astype(np.int32)
    return np.where(lag > S, protocol.DEAD_LAG, lag)


def _engine(**kw):
    return SlotEngine(K_max=32, k_cap=4, buckets=(4,), device="cpu", **kw)


def _sync_server(**kw):
    return SelectionServer(_engine(), **kw)


def _client(srv, **kw):
    return ServeClient.connect(srv.address, timeout=TIMEOUT, **kw)


def _join(threads):
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)


# ---------------------------------------------------------------------------
# wire compatibility with the JAX package
# ---------------------------------------------------------------------------


def _jax_rows(K_max):
    def row(seed, t):
        key = jax.random.fold_in(jax.random.PRNGKey(int(seed)), int(t))
        return torch.from_numpy(np.array(jax.random.gumbel(key, (K_max,), jnp.float32)))

    return row


def _drive(client, staleness, rounds=6):
    """Admit two jobs, tick them with packed bits or lags and a plain list,
    read stats, retire one: the responses, in order."""
    rng = np.random.default_rng(3)
    out = [client.hello()]
    jobs = [client.admit(K=32, k=4, seed=5), client.admit(K=24, k=3, seed=6, sigma_frac=0.8)]
    out.append(jobs)
    for t in range(rounds):
        for j, K in zip(jobs, (32, 24)):
            lag = _lags(rng, K, staleness)
            if t % 2:  # packed: lag codes (async) or success bits (sync)
                feed = dict(lags=lag) if staleness else dict(bits=lag == 0)
            else:  # a plain list
                feed = dict(x=lag if staleness else (lag == 0).astype(int))
            out.append(client.tick(j, **feed))
    out.append({k: v for k, v in client.stats()["stats"].items() if k in ("admitted", "ticks", "errors")})
    client.retire(jobs[0])
    with pytest.raises(Exception) as e:
        client.tick(jobs[0], bits=np.ones(32))
    out.append(e.value.code)
    return out


@pytest.mark.parametrize("staleness", [0, 2])
def test_the_clients_and_servers_of_both_packages_interoperate(staleness):
    eng = SlotEngine(K_max=32, k_cap=4, staleness=staleness, buckets=(4,), device="cpu")
    eng.gumbel_row = _jax_rows(32)
    with SelectionServer(eng) as srv, JServeClient.connect(srv.address, timeout=TIMEOUT) as c:
        port_side = _drive(c, staleness)
    jeng = JSlotEngine(K_max=32, k_cap=4, staleness=staleness, buckets=(4,))
    with JSelectionServer(jeng) as jsrv, ServeClient.connect(jsrv.address, timeout=TIMEOUT) as c:
        jax_side = _drive(c, staleness)
    assert port_side == jax_side
    assert port_side[0] == {"ok": True, "server": "repro-serve", "engine": "slots", "staleness": staleness,
                            "jobs": 0}


# ---------------------------------------------------------------------------
# transport: batcher, shed, timeout, drain
# ---------------------------------------------------------------------------


def test_transport_roundtrip_and_errors():
    with _sync_server() as srv, _client(srv) as c:
        assert c.hello()["engine"] == "slots"
        job = c.admit(K=32, k=4, seed=1)
        out = c.tick(job, bits=np.ones(32))
        assert out["round"] == 0 and len(out["cohort"]) == 4
        for bad, code in (
            (dict(op="tick", job=999, xb=protocol.encode_bits(np.ones(32))), "unknown_job"),
            (dict(op="tick", job=job), "bad_request"),  # no feedback field
            (dict(op="tick", job=job, x=[1, 0]), "bad_request"),  # wrong width
            (dict(op="nonsense"), "bad_request"),
            (dict(op="admit", spec={"K": 64, "k": 4}), "bad_request"),  # K > K_max
            (dict(op="admit", spec={"K": 8, "k": 2, "colour": 1}), "bad_request"),
            (dict(op="checkpoint"), "bad_request"),  # no ckpt_dir
        ):
            with pytest.raises(ServeError) as e:
                c.call(**bad)
            assert e.value.code == code
        c.retire(job)
        with pytest.raises(ServeError) as e:
            c.tick(job, bits=np.ones(32))
        assert e.value.code == "unknown_job"


def test_transport_concurrent_clients_batch():
    """Two clients ticking at once: every response is consistent and
    per-job rounds stay sequential however dispatches coalesce."""
    with _sync_server() as srv:
        rounds = {0: [], 1: []}

        def drive(i):
            with _client(srv) as c:
                job = c.admit(K=32, k=4, seed=i)
                for _ in range(20):
                    out = c.tick(job, bits=np.ones(32))
                    rounds[i].append(out["round"])
                    assert len(out["cohort"]) == 4

        threads = [threading.Thread(target=drive, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        _join(threads)
        assert rounds[0] == list(range(20)) and rounds[1] == list(range(20))
        assert srv.stats["ticks"] == 40 and srv.stats["dispatches"] <= 40


def test_transport_shed_on_full_queue():
    """A stalled engine and a bounded queue: overflow requests shed at once
    instead of queueing into unbounded latency."""
    srv = _sync_server(max_queue=2)
    gate = threading.Event()
    real_tick = srv.engine.tick

    def slow_tick(items):
        gate.wait(TIMEOUT)
        return real_tick(items)

    srv.engine.tick = slow_tick
    with srv, _client(srv) as admitc:
        job = admitc.admit(K=32, k=4, seed=1)
        results = []

        def one():
            with _client(srv) as c:
                try:
                    c.tick(job, bits=np.ones(32))
                    results.append("ok")
                except ServeError as e:
                    results.append(e.code)

        threads = [threading.Thread(target=one) for _ in range(6)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        gate.set()
        _join(threads)
    assert "shed" in results, results
    assert srv.stats["shed"] >= 1


def test_transport_timeout_expired_requests():
    """Requests older than request_timeout when dequeued fail with
    ``timeout`` and never reach the engine."""
    with _sync_server(request_timeout=0.0) as srv, _client(srv) as c:
        job = c.call(op="admit", spec={"K": 32, "k": 4})["job"]
        with pytest.raises(ServeError) as e:
            c.tick(job, bits=np.ones(32))
        assert e.value.code == "timeout"
    assert srv.stats["timeouts"] == 1 and srv.stats["ticks"] == 0


def test_transport_drain_and_final_checkpoint(tmp_path):
    """A graceful close answers accepted work and writes a final
    checkpoint, which restores to the drained state."""
    with _sync_server(ckpt_dir=str(tmp_path)) as srv, _client(srv) as c:
        job = c.admit(K=32, k=4, seed=5)
        for _ in range(3):
            c.tick(job, bits=np.ones(32))
    stem = latest_server_checkpoint(str(tmp_path))
    assert stem is not None and stem == srv.last_checkpoint
    eng, step = load_server(stem, device="cpu")
    assert step == 3 and int(eng.state.t[eng.jobs[job]["slot"]]) == 3 == eng.job_round(job)
    with open(stem + ".json") as f:
        assert json.load(f)["writer"] == "repro_torch"


def test_transport_draining_rejects_new_requests():
    with _sync_server() as srv, _client(srv) as c:
        c.admit(K=32, k=4)
        assert c.shutdown()["ok"]
        with pytest.raises((ServeError, protocol.ProtocolError, OSError)):
            c.call(op="hello")


# ---------------------------------------------------------------------------
# protocol fuzz: garbage on the wire never leaves a dead handler behind
# ---------------------------------------------------------------------------


def test_fuzz_random_bytes_never_kill_the_server():
    rng = np.random.default_rng(11)
    with _sync_server() as srv:
        for _ in range(12):
            s = socket.create_connection(srv.address, timeout=5.0)
            try:
                s.sendall(rng.integers(0, 256, int(rng.integers(1, 256)), dtype=np.uint8).tobytes())
            finally:
                s.close()
        with _client(srv) as c:
            assert c.hello()["ok"]


def test_fuzz_oversized_length_prefix():
    """A frame announcing more than MAX_MESSAGE_BYTES: an error response,
    then a hang-up (the stream cannot be resynced)."""
    with _sync_server() as srv:
        s = socket.create_connection(srv.address, timeout=5.0)
        try:
            s.sendall(struct.pack("!I", protocol.MAX_MESSAGE_BYTES + 1))
            resp = protocol.recv_message(s)
            assert resp["ok"] is False and resp["error"] == "bad_request"
            with pytest.raises((protocol.ProtocolError, OSError)):
                protocol.recv_message(s)
        finally:
            s.close()
        with _client(srv) as c:
            assert c.hello()["ok"]


def test_fuzz_truncated_frame_and_midframe_disconnect():
    with _sync_server() as srv:
        body = json.dumps({"op": "hello"}).encode()
        for cut in (0, len(body) // 2):
            s = socket.create_connection(srv.address, timeout=5.0)
            s.sendall(struct.pack("!I", len(body)) + body[:cut])
            s.close()
        s = socket.create_connection(srv.address, timeout=5.0)
        try:
            junk = b"\xff" * len(body)
            s.sendall(struct.pack("!I", len(junk)) + junk)
            resp = protocol.recv_message(s)
            assert resp["ok"] is False and resp["error"] == "bad_request"
        finally:
            s.close()
        with _client(srv) as c:
            assert c.hello()["ok"]


# ---------------------------------------------------------------------------
# crash-safe checkpoints: sha walk-back, retention
# ---------------------------------------------------------------------------


def test_checkpoint_walkback_and_retention(tmp_path):
    rng = np.random.default_rng(5)
    eng = _engine()
    uid = eng.admit(JobSpec(K=32, k=4, seed=3))
    stems = []
    for step in (1, 2, 3):
        eng.tick([(uid, _lags(rng, 32, S=0))])
        stems.append(save_server(str(tmp_path), eng, step=step))
    assert all(validate_stem(s) for s in stems)
    assert latest_server_checkpoint(str(tmp_path)) == stems[2]
    with open(stems[2] + ".ckpt", "r+b") as f:
        f.seek(0, 2)
        f.truncate(f.tell() // 2)
    assert not validate_stem(stems[2]) and latest_server_checkpoint(str(tmp_path)) == stems[1]
    plan = FaultPlan(corrupt_checkpoints=(0,), corrupt_mode="bitflip")
    plan.on_checkpoint(stems[1])
    assert plan.fired()["corrupt"] == 1
    assert not validate_stem(stems[1]) and latest_server_checkpoint(str(tmp_path)) == stems[0]
    restored, step = load_server(stems[0], device="cpu")
    assert step == 1 and restored.job_round(uid) == 1
    eng.tick([(uid, _lags(rng, 32, S=0))])
    s4 = save_server(str(tmp_path), eng, step=4, keep=2)
    left = sorted(f for f in os.listdir(str(tmp_path)) if f.endswith(".json"))
    assert len(left) == 2 and left[-1] == os.path.basename(s4) + ".json"


# ---------------------------------------------------------------------------
# idempotent ticks, client retries, numerics guard, hung engine
# ---------------------------------------------------------------------------


def test_idempotent_tick_replay_and_desync():
    with _sync_server() as srv, _client(srv) as c:
        job = c.admit(K=32, k=4, seed=2)
        xb = protocol.encode_bits(np.ones(32))
        out0 = c.call(op="tick", job=job, round=0, xb=xb)
        # a replay of round 0 with OTHER feedback: the cached response, the
        # engine untouched
        assert c.call(op="tick", job=job, round=0, xb=protocol.encode_bits(np.zeros(32))) == out0
        assert srv.stats["replayed"] == 1
        with pytest.raises(ServeError) as e:
            c.call(op="tick", job=job, round=5, xb=xb)
        assert e.value.code == "round_desync" and e.value.response["expected"] == 1
        assert c.call(op="tick", job=job, round=1, xb=xb)["round"] == 1


def test_client_retries_through_dropped_responses():
    """Dropped responses after execution: the retrying client reconnects,
    resends the same round, and the cache answers; the feedback lands
    exactly once."""
    plan = FaultPlan(drop_responses=(3, 5))
    with _sync_server(faults=plan) as srv, _client(srv, retries=4, seed=0) as c:
        job = c.admit(K=32, k=4, seed=1)
        got = [c.tick(job, bits=np.ones(32))["cohort"] for _ in range(8)]
    ref = _engine()
    u = ref.admit(JobSpec(K=32, k=4, seed=1))
    assert got == [ref.tick([(u, np.zeros(32, np.int32))])[u]["cohort"] for _ in range(8)]
    assert plan.fired()["drop"] == 2
    assert srv.stats["replayed"] == 2 and srv.stats["ticks"] == 8


def test_numerics_guard_refuses_update():
    """A non-finite selector update is refused inside the step: the request
    fails with ``numerics``, the cursor stays, an alert is raised."""
    with _sync_server() as srv, _client(srv) as c:
        job = c.admit(K=32, k=4, seed=1)
        c.tick(job, bits=np.ones(32))
        srv.engine.state.logw[srv.engine.jobs[job]["slot"], 0] = float("nan")
        with pytest.raises(ServeError) as e:
            c.tick(job, bits=np.ones(32))
        assert e.value.code == "numerics" and c.stats()["stats"]["numerics"] == 1
    assert srv.engine.job_round(job) == 1
    assert any(a.rule == "numerics" for a in srv.alerts)


def test_close_surfaces_hung_engine():
    srv = _sync_server(stop_timeout=0.3)
    gate = threading.Event()
    real_tick = srv.engine.tick

    def stuck(items):
        gate.wait(TIMEOUT)
        return real_tick(items)

    srv.engine.tick = stuck
    srv.start()
    c = _client(srv)
    job = c.admit(K=32, k=4, seed=1)

    def one():
        try:
            c.tick(job, bits=np.ones(32))
        except (ServeError, protocol.ProtocolError, OSError):
            pass

    t = threading.Thread(target=one)
    t.start()
    time.sleep(0.3)  # let the engine thread block inside the tick
    srv.close(checkpoint=False)
    assert srv.stats["hung_engine"] == 1
    gate.set()
    _join([t])
    c.close()


# ---------------------------------------------------------------------------
# supervised recovery
# ---------------------------------------------------------------------------


def _drive_with_replay(c, job, feed, *, rounds):
    """Round-cursor loop that survives retries, cache replay and recovery
    rollback: on ``round_desync`` it rewinds to the expected round."""
    got, t = {}, 0
    while t < rounds:
        try:
            out = c.tick(job, lags=feed[t], round=t)
        except ServeError as e:
            if e.code == "round_desync":
                t = int(e.response["expected"])
                continue
            raise
        got[out["round"]] = out["cohort"]
        t = out["round"] + 1
    return [got[i] for i in range(rounds)]


def test_supervisor_restart_from_checkpoint(tmp_path):
    """An injected engine crash: the supervisor restores the newest valid
    checkpoint, the client rewinds and replays, the cohort stream equals a
    fault-free run, and the crashed engine (with its step) is freed as the
    restored one takes over, with the collector off."""
    ROUNDS = 12
    plan = FaultPlan(crash_steps=(7,))
    rng = np.random.default_rng(3)
    feed = [_lags(rng, 32, S=0) for _ in range(ROUNDS)]
    ref = _engine()
    u = ref.admit(JobSpec(K=32, k=4, seed=9))
    want = [ref.tick([(u, f)])[u]["cohort"] for f in feed]
    srv = SelectionServer(_engine(), ckpt_dir=str(tmp_path), ckpt_every=3, faults=plan, restart_backoff=0.01)
    first, first_step = weakref.ref(srv.engine), weakref.ref(srv.engine._step)
    gc.disable()
    try:
        with srv, _client(srv, retries=6, seed=1) as c:
            job = c.admit(K=32, k=4, seed=9)
            got = _drive_with_replay(c, job, feed, rounds=ROUNDS)
            stats = c.stats()["stats"]
            assert first() is None and first_step() is None and srv.engine is not None
    finally:
        gc.enable()
    assert got == want
    assert plan.fired()["crash"] == 1 and stats["restarts"] == 1
    assert stats["degraded"] == 0  # cleared by the first clean dispatch
    assert len(srv.recoveries) == 1 and any(a.rule == "engine_restart" for a in srv.alerts)
    assert srv.serve_series()["restarts"].sum() == 1


def test_restart_budget_exhaustion_answers_engine_down(tmp_path):
    plan = FaultPlan(crash_steps=(0, 1, 2, 3))
    srv = SelectionServer(_engine(), ckpt_dir=str(tmp_path), faults=plan, max_restarts=2, restart_backoff=0.0)
    with srv, _client(srv, retries=8, seed=2) as c:
        job = c.admit(K=32, k=4, seed=1)
        with pytest.raises(ServeError) as e:
            _drive_with_replay(c, job, [_lags(np.random.default_rng(0), 32, S=0)], rounds=1)
        assert e.value.code in ("retry", "engine_down")
        with pytest.raises(ServeError) as e:
            c.call(op="tick", job=job, round=0, xb=protocol.encode_bits(np.ones(32)))
        assert e.value.code == "engine_down"
    assert srv.stats["restarts"] == 3  # 2 allowed and the one that broke the budget

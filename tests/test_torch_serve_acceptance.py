"""The serving acceptance runs of the JAX package (``tests/test_serve.py``'s
sharded-async kill/restore and chaos cases) on the port: a
``ShardedEngine(staleness=2)`` on a one-rank gloo group behind a
``SelectionServer`` over loopback, two jobs.

* **Kill and restore.** 52 rounds, a checkpoint and ``kill()`` after 26, a
  fresh server restored from disk finishes the horizon.
* **Chaos.** JAX's plan: a crash at dispatch 25, the fourth checkpoint
  corrupted, responses 12 and 31 dropped, dispatch 5 slowed, a checkpoint
  every 6 rounds: recovery walks past the corrupt step-24 stem to step 18,
  the client rewinds and replays, and the crashed engine is freed as the
  restored one takes over, with no tensor left in a reference cycle.

In both, every cohort is bit for bit an uninterrupted engine's.
"""
import gc
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.serve import FaultPlan, JobSpec, SelectionServer, ServeClient, ServeError, ShardedEngine
from repro_torch.serve import latest_server_checkpoint, load_server, protocol

TIMEOUT = 60.0  # every client socket and wait


@pytest.fixture(scope="module")
def gloo1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _lags(rng, K, S=2):
    lag = rng.integers(0, S + 2, K).astype(np.int32)
    return np.where(lag > S, protocol.DEAD_LAG, lag)


def _engine():
    return ShardedEngine(D=1, staleness=2, device="cpu")


def _reference(specs, feed, rounds):
    ref = _engine()
    uids = [ref.admit(JobSpec(**s)) for s in specs]
    ticks = [ref.tick([(u, f[t]) for u, f in zip(uids, feed)]) for t in range(rounds)]
    return [[r[u]["cohort"] for u in uids] for r in ticks]


def test_kill_and_restore_mid_horizon(gloo1, tmp_path):
    ROUNDS, SPLIT = 52, 26
    rng = np.random.default_rng(7)
    specs = [dict(K=64, k=8, rounds=ROUNDS, seed=17), dict(K=48, k=4, rounds=ROUNDS, seed=23)]
    feed = [[_lags(rng, s["K"]) for _ in range(ROUNDS)] for s in specs]
    want = _reference(specs, feed, ROUNDS)
    ckpt_dir = str(tmp_path / "ckpt")
    got = {0: [], 1: []}
    srv = SelectionServer(_engine(), ckpt_dir=ckpt_dir)
    with srv:
        with ServeClient.connect(srv.address, timeout=TIMEOUT) as c:
            jobs = [c.admit(**s) for s in specs]
            for t in range(SPLIT):
                for i, j in enumerate(jobs):
                    out = c.tick(j, lags=feed[i][t])
                    got[i].append((out["round"], out["cohort"]))
            c.checkpoint()
        srv.kill()  # a crash: no drain, no final checkpoint
    stem = latest_server_checkpoint(ckpt_dir)
    engine, step = load_server(stem, device="cpu")
    assert step == 2 * SPLIT
    with SelectionServer(engine, ckpt_dir=ckpt_dir) as srv2, ServeClient.connect(srv2.address, timeout=TIMEOUT) as c:
        for t in range(SPLIT, ROUNDS):
            for i, j in enumerate(jobs):
                out = c.tick(j, lags=feed[i][t])
                got[i].append((out["round"], out["cohort"]))
    for i in range(2):
        assert [r for r, _ in got[i]] == list(range(ROUNDS))
        assert [cohort for _, cohort in got[i]] == [w[i] for w in want], f"job {i} diverged"


def test_chaos_plan_is_bit_identical_and_recovers_from_step_18(gloo1, tmp_path):
    ROUNDS = 30
    rng = np.random.default_rng(29)
    specs = [dict(K=64, k=8, rounds=ROUNDS, seed=31), dict(K=48, k=4, rounds=ROUNDS, seed=37)]
    feed = [[_lags(rng, s["K"]) for _ in range(ROUNDS)] for s in specs]
    want = _reference(specs, feed, ROUNDS)
    # a sequential client: one tick a dispatch, so checkpoints land at rounds
    # 6/12/18/24 (writes 0..3); corrupting write 3 spoils the newest stem
    # before the crash at dispatch 25, so recovery must walk back to 18
    plan = FaultPlan(crash_steps=(25,), corrupt_checkpoints=(3,), drop_responses=(12, 31), slow_steps={5: 0.02})
    srv = SelectionServer(_engine(), ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=6, faults=plan,
                          restart_backoff=0.01)
    crashed = weakref.ref(srv.engine)
    gc.collect()  # what earlier tests left for the collector is not this run's
    gc.disable()  # the crashed engine must go by reference counting alone
    try:
        with srv, ServeClient.connect(srv.address, timeout=TIMEOUT, retries=6, seed=5) as c:
            jobs = [c.admit(**s) for s in specs]
            cursors = {i: 0 for i in range(len(jobs))}
            got = {i: {} for i in range(len(jobs))}
            while any(t < ROUNDS for t in cursors.values()):
                for i, j in enumerate(jobs):
                    t = cursors[i]
                    if t >= ROUNDS:
                        continue
                    try:
                        out = c.tick(j, lags=feed[i][t], round=t)
                    except ServeError as e:
                        if e.code == "round_desync":
                            cursors[i] = int(e.response["expected"])
                            continue
                        raise
                    got[i][out["round"]] = out["cohort"]
                    cursors[i] = out["round"] + 1
            stats = c.stats()["stats"]
            assert crashed() is None
        # nothing of the crashed engine (nor of the reference one) waits in a
        # reference cycle: the collector finds no tensor to free
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cycled = [tuple(o.shape) for o in gc.garbage if isinstance(o, torch.Tensor)]
        assert not cycled, cycled
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert plan.fired() == {"crash": 1, "corrupt": 1, "drop": 2, "slow": 1}
    assert stats["restarts"] == 1 and stats["replayed"] >= 1
    restart = [a for a in srv.alerts if a.rule == "engine_restart"]
    assert len(restart) == 1 and restart[0].detail["restored_step"] == 18
    assert restart[0].detail["checkpoint"].endswith("ckpt_00000018")
    assert srv.serve_series()["restarts"].sum() == 1 and srv.serve_series()["recovery_s"].sum() > 0
    for i in range(2):
        assert sorted(got[i]) == list(range(ROUNDS))
        assert [got[i][t] for t in range(ROUNDS)] == [w[i] for w in want], f"job {i} diverged"

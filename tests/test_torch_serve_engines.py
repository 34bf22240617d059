"""The serving engines and the wire protocol of the port against the JAX
package's (``repro_torch.serve`` against ``repro.serve``).

* **Protocol.** Frames and the ``xb`` / ``xl`` strings are JAX's byte for
  byte; the decodes and ``feedback_lags`` agree.
* **SlotEngine against JAX's.** The same admit, retire and ladder-growth
  sequence, the port handed JAX's Gumbel rows (``fold_in(PRNGKey(seed),
  t)``) through ``gumbel_row``: rounds, cohorts, ``on_time``, ``stale``, the
  round counters and the ring exactly; ``logw`` within JAX's own
  ``LOGW_ATOL`` (the frameworks sum the bisection's tiles in other orders,
  so a weight may differ in its last bits); ``meta()`` equal.  The ladder
  and ``CapacityError`` as in JAX; a JAX engine's state carried in through
  ``convert`` continues with JAX's cohorts.
* **The port's own noise**, bit for bit: a job alone equals the job batched,
  growth keeps every stream, a restart at S in {0, 2} continues exactly, and
  the NaN guard refuses an update and leaves the state as it was.
* **ShardedEngine on a one-rank gloo group.** Ticks equal the port's own
  ``build_runner`` horizon over the same feedback (held against JAX in
  ``test_torch_sharded.py``), sync and async, deadline and late credit;
  restart and the guard as above; a JAX job's state carried in.
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro.serve import CapacityError as JCapacityError
from repro.serve import JobSpec as JJobSpec
from repro.serve import ShardedEngine as JShardedEngine
from repro.serve import SlotEngine as JSlotEngine
from repro.serve import protocol as jprotocol
from repro_torch.configs import FLConfig
from repro_torch.convert import sharded_job_from_jax, slot_state_from_jax, state_to_numpy
from repro_torch.engine import RoundProgram
from repro_torch.launch import make_host_mesh
from repro_torch.serve import CapacityError, JobSpec, NumericsError, ShardedEngine, SlotEngine, engine_from_meta
from repro_torch.serve import load_server, protocol, save_server

LOGW_ATOL = 1e-5  # the JAX package's own (tests/test_engine.py)
SPECS = [dict(K=64, k=8, seed=1), dict(K=48, k=6, seed=2, sigma_frac=0.8, eta=0.3),
         dict(K=32, k=4, seed=3, sigma_frac=0.0), dict(K=40, k=5, seed=4, eta=0.3)]


def _lags(rng, K, S=2):
    """A volatile round: most on time, some late (1..S), some never."""
    lag = rng.integers(0, S + 2, K).astype(np.int32)
    return np.where(lag > S, protocol.DEAD_LAG, lag)


def jax_rows(K_max):
    """The Gumbel row JAX's SlotEngine draws for job (seed, t)."""

    def row(seed, t):
        key = jax.random.fold_in(jax.random.PRNGKey(int(seed)), int(t))
        return torch.from_numpy(np.array(jax.random.gumbel(key, (K_max,), jnp.float32)))

    return row


def _bits(t):
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.uint8)


# ---------------------------------------------------------------------------
# protocol
# ---------------------------------------------------------------------------


def _frame_bytes(send, msg):
    a, b = socket.socketpair()
    try:
        send(a, msg)
        a.close()
        chunks = []
        while chunk := b.recv(1 << 16):
            chunks.append(chunk)
        return b"".join(chunks)
    finally:
        b.close()


def test_frames_are_jaxs_byte_for_byte():
    rng = np.random.default_rng(0)
    msgs = [
        {"op": "tick", "job": 3, "round": 7, "xb": protocol.encode_bits(rng.random(1000) < 0.5)},
        {"ok": True, "round": 2, "cohort": [5, 1, 9], "on_time": 2.0, "stale": 0.375},
        {"ok": False, "error": "round_desync", "message": "job 0 is at round 4 — replay", "expected": 4},
        {"op": "admit", "spec": {"K": 4096, "k": 64, "sigma_frac": 0.5, "seed": 11}},
    ]
    for msg in msgs:
        raw = _frame_bytes(protocol.send_message, msg)
        assert raw == _frame_bytes(jprotocol.send_message, msg)
        a, b = socket.socketpair()
        try:
            a.sendall(raw)
            assert protocol.recv_message(b) == msg
        finally:
            a.close()
            b.close()


@pytest.mark.parametrize("K", [1, 9, 1000, 4099])
def test_feedback_encodings_are_jaxs(K):
    rng = np.random.default_rng(K)
    bits = rng.random(K) < 0.6
    lags = rng.integers(-3, 300, K)
    xb, xl = protocol.encode_bits(bits), protocol.encode_lags(lags)
    assert xb == jprotocol.encode_bits(bits) and xl == jprotocol.encode_lags(lags)
    np.testing.assert_array_equal(protocol.decode_bits(xb, K), jprotocol.decode_bits(xb, K))
    np.testing.assert_array_equal(protocol.decode_lags(xl, K), jprotocol.decode_lags(xl, K))
    plain = [int(v) for v in rng.integers(-1, 3, K)]
    for req in ({"xb": xb}, {"xl": xl}, {"x": plain}, {}):
        for S in (0, 2):
            got, want = protocol.feedback_lags(req, K, S), jprotocol.feedback_lags(req, K, S)
            assert (got is None and want is None) or (got.dtype == want.dtype and np.array_equal(got, want))
    with pytest.raises(protocol.ProtocolError):
        protocol.decode_bits(protocol.encode_bits(bits[: K // 2]), K + 8)
    with pytest.raises(protocol.ProtocolError):
        protocol.feedback_lags({"x": plain + [0]}, K, 0)


def test_protocol_framing_errors():
    a, b = socket.socketpair()
    try:
        a.sendall(b"\x00\x00\x00\x10{\"tru")  # announce 16 bytes, send 6
        a.close()
        with pytest.raises(protocol.ProtocolError):
            protocol.recv_message(b)
    finally:
        b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(b"\x00\x00\x00\x02[]")
        with pytest.raises(protocol.ProtocolError, match="not a JSON object"):
            protocol.recv_message(b)
        a.close()
        with pytest.raises(protocol.ConnectionClosed):
            protocol.recv_message(b)
    finally:
        b.close()


# ---------------------------------------------------------------------------
# SlotEngine against JAX's
# ---------------------------------------------------------------------------


def _pair(staleness, K_max=64, k_cap=8, buckets=(2, 4)):
    jeng = JSlotEngine(K_max=K_max, k_cap=k_cap, staleness=staleness, buckets=buckets)
    eng = SlotEngine(K_max=K_max, k_cap=k_cap, staleness=staleness, buckets=buckets, device="cpu")
    eng.gumbel_row = jax_rows(K_max)
    return jeng, eng


def _same_state(jeng, eng):
    np.testing.assert_array_equal(eng.state.t.numpy(), np.asarray(jeng.state.t))
    np.testing.assert_allclose(eng.state.logw.numpy(), np.asarray(jeng.state.logw), rtol=0, atol=LOGW_ATOL)
    np.testing.assert_array_equal(eng.pending.numpy(), np.asarray(jeng.pending))


@pytest.mark.parametrize("staleness", [0, 2])
def test_slot_engine_selects_jaxs_cohorts(staleness):
    """Admit two jobs, tick, admit a third (the ladder grows 2 -> 4), tick,
    retire the first, admit a fourth into its slot, and tick a subset."""
    rng = np.random.default_rng(staleness)
    jeng, eng = _pair(staleness)

    def admit(i):
        spec = SPECS[i]
        ju, u = jeng.admit(JJobSpec(**spec)), eng.admit(JobSpec(**spec))
        assert ju == u
        return u

    def tick(uids, n):
        for _ in range(n):
            items = [(u, _lags(rng, eng.jobs[u]["spec"].K, staleness)) for u in uids]
            assert eng.tick(items) == jeng.tick(items)
            _same_state(jeng, eng)

    u0, u1 = admit(0), admit(1)
    tick([u0, u1], 3)
    u2 = admit(2)
    assert eng.n_slots == jeng.n_slots == 4
    tick([u0, u1, u2], 3)
    jeng.retire(u0)
    eng.retire(u0)
    u3 = admit(3)
    assert eng.jobs[u3]["slot"] == jeng.jobs[u3]["slot"] == 0
    tick([u3, u2], 2)
    tick([u1, u3], 2)
    assert eng.meta() == jeng.meta()
    assert [eng.job_round(u) for u in (u1, u2, u3)] == [jeng.job_round(u) for u in (u1, u2, u3)] == [8, 5, 4]


def test_bucket_ladder_and_capacity_are_jaxs():
    jeng, eng = _pair(0, K_max=16, k_cap=4)
    for i in range(4):
        assert eng.admit(JobSpec(K=16, k=2, seed=i)) == jeng.admit(JJobSpec(K=16, k=2, seed=i))
        assert eng.n_slots == jeng.n_slots
    with pytest.raises(CapacityError):
        eng.admit(JobSpec(K=16, k=2, seed=99))
    with pytest.raises(JCapacityError):
        jeng.admit(JJobSpec(K=16, k=2, seed=99))
    eng.retire(1)
    jeng.retire(1)
    assert eng.admit(JobSpec(K=16, k=2, seed=100)) == jeng.admit(JJobSpec(K=16, k=2, seed=100)) == 4
    assert eng.n_slots == jeng.n_slots == 4 and eng.meta() == jeng.meta()
    for bad in (dict(K=17, k=2), dict(K=16, k=5)):
        with pytest.raises(ValueError):
            eng.admit(JobSpec(**bad))
    with pytest.raises(ValueError, match="ladder"):
        SlotEngine(buckets=(4, 2), device="cpu")


@pytest.mark.parametrize("staleness", [0, 2])
def test_a_jax_engines_state_continues_with_jaxs_cohorts(staleness):
    rng = np.random.default_rng(9)
    jeng = JSlotEngine(K_max=64, k_cap=8, staleness=staleness, buckets=(4,))
    uids = [jeng.admit(JJobSpec(**s)) for s in SPECS[:3]]
    feed = [[(u, _lags(rng, SPECS[i]["K"], staleness)) for i, u in enumerate(uids)] for _ in range(6)]
    for items in feed[:3]:
        jeng.tick(items)
    eng = engine_from_meta(jeng.meta(), device="cpu")
    slot_state_from_jax(eng, {n: np.asarray(v) for n, v in jeng.arrays().items()})
    eng.gumbel_row = jax_rows(64)
    assert [eng.job_round(u) for u in uids] == [3, 3, 3]
    for items in feed[3:]:
        assert eng.tick(items) == jeng.tick(items)
    _same_state(jeng, eng)


# ---------------------------------------------------------------------------
# SlotEngine with the port's own noise
# ---------------------------------------------------------------------------


def test_a_job_alone_equals_the_job_batched():
    rng = np.random.default_rng(0)
    spec = JobSpec(K=48, k=6, seed=13)
    feed = [_lags(rng, 48) for _ in range(8)]
    alone = SlotEngine(K_max=64, k_cap=8, staleness=2, buckets=(4,), device="cpu")
    ua = alone.admit(spec)
    solo = [alone.tick([(ua, f)])[ua] for f in feed]
    packed = SlotEngine(K_max=64, k_cap=8, staleness=2, buckets=(4,), device="cpu")
    u0 = packed.admit(JobSpec(K=64, k=8, seed=1))
    ub = packed.admit(spec)
    u2 = packed.admit(JobSpec(K=32, k=4, seed=2))
    both = [packed.tick([(u0, _lags(rng, 64)), (ub, f), (u2, _lags(rng, 32))])[ub] for f in feed]
    assert solo == both
    assert torch.equal(_bits(alone.state.logw[0]), _bits(packed.state.logw[1]))


def test_growth_preserves_every_stream():
    rng = np.random.default_rng(1)
    specs = [JobSpec(K=24, k=3, seed=21), JobSpec(K=32, k=4, seed=22)]
    feed = [[_lags(rng, s.K, 0) for s in specs] for _ in range(6)]
    ref = SlotEngine(K_max=32, k_cap=4, buckets=(4,), device="cpu")
    ur = [ref.admit(s) for s in specs]
    want = [ref.tick(list(zip(ur, f))) for f in feed]
    grow = SlotEngine(K_max=32, k_cap=4, buckets=(2, 4), device="cpu")
    ug = [grow.admit(s) for s in specs]
    got = [grow.tick(list(zip(ug, f))) for f in feed[:3]]
    grow.admit(JobSpec(K=32, k=4, seed=1))  # 2 -> 4 slots
    got += [grow.tick(list(zip(ug, f))) for f in feed[3:]]
    assert got == want and grow.n_slots == 4


@pytest.mark.parametrize("staleness", [0, 2])
def test_slot_engine_restart_continues_exactly(tmp_path, staleness):
    rng = np.random.default_rng(2)
    specs = [JobSpec(K=40, k=5, seed=3), JobSpec(K=24, k=4, seed=4)]
    feed = [[_lags(rng, s.K, staleness) for s in specs] for _ in range(12)]

    def fresh():
        eng = SlotEngine(K_max=64, k_cap=8, staleness=staleness, buckets=(4,), device="cpu")
        return eng, [eng.admit(s) for s in specs]

    ref, uref = fresh()
    want = [ref.tick(list(zip(uref, f))) for f in feed]
    eng, uids = fresh()
    for f in feed[:6]:
        eng.tick(list(zip(uids, f)))
    eng2, step = load_server(save_server(str(tmp_path), eng, step=6), device="cpu")
    assert step == 6 and eng2.meta() == eng.meta()
    assert [eng2.tick(list(zip(uids, f))) for f in feed[6:]] == want[6:]
    for a, b in zip(pytree.tree_leaves(eng2.arrays()), pytree.tree_leaves(ref.arrays())):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("staleness", [0, 2])
def test_the_nan_guard_refuses_the_update(staleness):
    rng = np.random.default_rng(4)
    eng = SlotEngine(K_max=32, k_cap=4, staleness=staleness, buckets=(4,), device="cpu")
    uids = [eng.admit(JobSpec(K=32, k=4, seed=s)) for s in (1, 2)]
    for _ in range(2):
        eng.tick([(u, _lags(rng, 32, staleness)) for u in uids])
    eng.state.logw[eng.jobs[uids[1]]["slot"], 0] = float("nan")
    before = [_bits(a).clone() for a in pytree.tree_leaves(eng.arrays())]
    with pytest.raises(NumericsError):
        eng.tick([(u, _lags(rng, 32, staleness)) for u in uids])
    assert all(torch.equal(a, _bits(b)) for a, b in zip(before, pytree.tree_leaves(eng.arrays())))
    assert [eng.job_round(u) for u in uids] == [2, 2]
    out = eng.tick([(uids[0], _lags(rng, 32, staleness))])  # a batch without the broken job goes through
    assert out[uids[0]]["round"] == 2 and eng.job_round(uids[1]) == 2


# ---------------------------------------------------------------------------
# ShardedEngine on a one-rank gloo group
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gloo1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


K_SH, k_SH, T_SH = 256, 16, 6


@pytest.mark.parametrize("staleness,feedback", [(0, "deadline"), (2, "deadline"), (2, "late_credit")])
def test_sharded_engine_ticks_equal_the_runner_horizon(gloo1, staleness, feedback):
    rng = np.random.default_rng(staleness)
    feed = np.stack([_lags(rng, K_SH, staleness) for _ in range(T_SH)])
    spec = JobSpec(K=K_SH, k=k_SH, rounds=T_SH, seed=7)
    eng = ShardedEngine(D=1, staleness=staleness, feedback=feedback, device="cpu")
    uid = eng.admit(spec)
    got = [eng.tick([(uid, f)])[uid] for f in feed]
    fl = FLConfig(K=K_SH, k=k_SH, rounds=T_SH, scheme="e3cs", quota_frac=0.5, eta=0.5, allocator="bisect",
                  staleness_rounds=staleness)
    pm = RoundProgram.from_config(fl, mesh=make_host_mesh(1, device="cpu"), override="dense", feedback=feedback,
                                  block=4)
    run, s0 = pm.build_runner(outputs="full")
    out = run(s0, 7, pm.local_rows(feed if staleness else (feed == 0).astype(np.float32)))
    masks = out[1].numpy()
    for t, r in enumerate(got):
        assert r["round"] == t and r["cohort"] == np.nonzero(masks[t])[0].tolist()
        assert r["on_time"] == float((masks[t] * (feed[t] == 0)).sum())
        assert r["stale"] == (float(out[5][t].sum()) if staleness else 0.0)
    for a, b in zip(pytree.tree_leaves(eng.jobs[uid]["state"]), pytree.tree_leaves(out[0])):
        assert torch.equal(_bits(a), _bits(b))


def test_sharded_engine_restart_and_guard(gloo1, tmp_path):
    rng = np.random.default_rng(11)
    specs = [JobSpec(K=K_SH, k=k_SH, rounds=12, seed=17), JobSpec(K=192, k=8, rounds=12, seed=23)]
    feed = [[_lags(rng, s.K) for s in specs] for _ in range(10)]

    def fresh():
        eng = ShardedEngine(D=1, staleness=2, device="cpu")
        return eng, [eng.admit(s) for s in specs]

    ref, uref = fresh()
    want = [ref.tick(list(zip(uref, f))) for f in feed]
    eng, uids = fresh()
    for f in feed[:5]:
        eng.tick(list(zip(uids, f)))
    eng2, step = load_server(save_server(str(tmp_path), eng, step=10), device="cpu")
    assert step == 10 and eng2.meta() == eng.meta()
    assert [eng2.tick(list(zip(uids, f))) for f in feed[5:]] == want[5:]
    job = eng2.jobs[uids[0]]
    job["state"].e3cs.logw[3] = float("inf")
    held = (job["state"], job["key"], job["rings"])
    with pytest.raises(NumericsError):
        eng2.tick([(uids[0], feed[0][0])])
    assert all(a is b for a, b in zip((job["state"], job["key"], job["rings"]), held))
    assert eng2.job_round(uids[0]) == 10
    with pytest.raises(ValueError, match="D=2"):
        ShardedEngine(D=2, device="cpu")


@pytest.mark.parametrize("kind", ["slot", "sharded"])
def test_a_restart_after_a_retire_keeps_every_jobs_uid(gloo1, tmp_path, kind):
    rng = np.random.default_rng(13)
    specs = [JobSpec(K=64, k=4, rounds=8, seed=s) for s in (31, 32, 33)]
    feed = [[_lags(rng, 64) for _ in specs] for _ in range(6)]

    def fresh():
        if kind == "slot":
            eng = SlotEngine(K_max=64, k_cap=8, staleness=2, buckets=(4,), device="cpu")
        else:
            eng = ShardedEngine(D=1, staleness=2, device="cpu")
        uids = [eng.admit(s) for s in specs]
        eng.retire(uids[0])
        return eng, uids[1:]

    ref, uref = fresh()
    want = [ref.tick(list(zip(uref, f[1:]))) for f in feed]
    eng, uids = fresh()
    for f in feed[:3]:
        eng.tick(list(zip(uids, f[1:])))
    eng2, step = load_server(save_server(str(tmp_path), eng, step=3), device="cpu")
    assert step == 3 and eng2.meta() == eng.meta() and sorted(eng2.jobs) == uids == [1, 2]
    assert [eng2.tick(list(zip(uids, f[1:]))) for f in feed[3:]] == want[3:]
    assert eng2.admit(specs[0]) == 3  # a new job takes a fresh uid


def test_a_jax_sharded_jobs_state_carries_in(gloo1):
    rng = np.random.default_rng(5)
    spec = dict(K=K_SH, k=k_SH, rounds=10, seed=3)
    jeng = JShardedEngine(D=1, staleness=2)
    uid = jeng.admit(JJobSpec(**spec))
    for _ in range(3):
        jeng.tick([(uid, _lags(rng, K_SH))])
    eng = engine_from_meta(jeng.meta(), device="cpu")
    job = jeng.arrays()[str(uid)]
    sharded_job_from_jax(eng, uid, job)
    st = job["state"]
    want = {"logw": st.e3cs.logw, "sel_counts": st.sel_counts, "cep": st.cep, "t": st.t, "credit": job["rings"][0]}
    got = state_to_numpy(eng.jobs[uid]["state"], eng.jobs[uid]["rings"])
    for name, v in want.items():
        np.testing.assert_array_equal(got[name], np.asarray(v), err_msg=name)
    assert eng.job_round(uid) == jeng.job_round(uid) == 3
    out = eng.tick([(uid, _lags(rng, K_SH))])[uid]
    assert out["round"] == 3 and len(set(out["cohort"])) == k_SH

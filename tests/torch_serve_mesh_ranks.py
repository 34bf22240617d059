"""The ranks' side of ``test_torch_serve_mesh.py``: every case of one
D-rank group, run by ``test_torch_mesh.spawn_groups`` in spawned gloo ranks.
Nothing here imports JAX.

``serve_mesh_rank(mesh, work_dir, jax_npz, d4_stem)`` first runs the mesh
runner's horizons on every rank (the reference of case a), then the engine
cases with rank 0 leading and the other ranks in one ``follow`` loop, then
(D = 2) the command line twice.  Rank 0 returns the results as numpy arrays;
the followers return what their loops returned.
"""
import contextlib
import gc
import io
import json
import os
import types
import weakref

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import FLConfig
from repro_torch.convert import gather_state, sharded_job_from_jax, state_to_numpy
from repro_torch.engine import RoundProgram
from repro_torch.serve import FaultPlan, JobSpec, NumericsError, SelectionServer, ServeClient, ServeError
from repro_torch.serve import ShardedEngine, engine_from_meta, follow, latest_server_checkpoint, load_server
from repro_torch.serve import engines, protocol, save_server, stop_followers
from test_torch_mesh import lap

TIMEOUT = 60.0  # every client socket and wait
K_SH, k_SH, T_SH = 256, 16, 6
RUNNER_CASES = [(0, "deadline"), (2, "deadline"), (2, "late_credit")]
ACCEPT_SPECS = [dict(K=64, k=8, seed=17), dict(K=48, k=4, seed=23)]  # tests/test_serve.py's
CHAOS_SPECS = [dict(K=64, k=8, seed=31), dict(K=48, k=4, seed=37)]
KILL_ROUNDS, KILL_SPLIT, CHAOS_ROUNDS = 52, 26, 30


def lags(rng, K, S=2):
    """A volatile round: most on time, some late (1..S), some never."""
    lag = rng.integers(0, S + 2, K).astype(np.int32)
    return np.where(lag > S, protocol.DEAD_LAG, lag)


def runner_feed(S):
    rng = np.random.default_rng(S)
    return np.stack([lags(rng, K_SH, S) for _ in range(T_SH)])


def _bits(tree):
    """Every tensor leaf as its integer bits (NaNs compare equal)."""
    return [t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.uint8)
            for t in pytree.tree_leaves(tree)]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_bits(a), _bits(b))) and len(_bits(a)) == len(_bits(b))


def runner_case(mesh, S, feedback):
    """The port's mesh runner (``carry_key``, one shot) over
    ``runner_feed(S)`` on every rank: each round's cohort, ``on_time`` and
    ``stale`` as the engine forms them, and the final state and rings
    gathered whole."""
    feed = runner_feed(S)
    fl = FLConfig(K=K_SH, k=k_SH, rounds=T_SH, scheme="e3cs", quota_frac=0.5, eta=0.5, allocator="bisect",
                  staleness_rounds=S)
    pm = RoundProgram.from_config(fl, mesh=mesh, override="dense", feedback=feedback, block=4)
    run, s0 = pm.build_runner(outputs="full", carry_key=True)
    xs = pm.local_rows(feed if S else (feed == 0).astype(np.float32))
    if S:
        state, _, rings, masks, _, _, _, arrived = run(s0, 7, pm.init_rings(), xs)
    else:
        (state, _, masks, _, _, _), rings = run(s0, 7, xs), ()
    cohorts, sums = [], []
    for t in range(T_SH):
        cohorts.append(torch.nonzero(mesh.all_gather(masks[t]) > 0).flatten().numpy())
        on_time = torch.sum(masks[t] * (xs[t] == 0 if S else xs[t]))
        stale = torch.sum(arrived[t]) if S else torch.zeros(())
        sums.append(mesh.psum(torch.stack([torch.zeros(()), on_time, stale]))[1:])
    tag = f"runner/S{S}/{feedback}"
    return {f"{tag}/cohorts": np.stack(cohorts), f"{tag}/sums": torch.stack(sums).numpy(),
            **{f"{tag}/state/{n}": v for n, v in gather_state(state, rings, mesh).items()}}


def engine_case(S, feedback):
    """Case (a) on rank 0: ``ShardedEngine`` ticks over the runner's feed."""
    eng = ShardedEngine(staleness=S, feedback=feedback, device="cpu")
    uid = eng.admit(JobSpec(K=K_SH, k=k_SH, rounds=T_SH, seed=7))
    got = [eng.tick([(uid, f)])[uid] for f in runner_feed(S)]
    blob = eng.arrays()[str(uid)]
    tag = f"engine/S{S}/{feedback}"
    return {f"{tag}/rounds": np.array([r["round"] for r in got]),
            f"{tag}/cohorts": np.stack([np.array(r["cohort"]) for r in got]),
            f"{tag}/sums": np.array([[r["on_time"], r["stale"]] for r in got], np.float32),
            **{f"{tag}/state/{n}": v for n, v in state_to_numpy(blob["state"], tuple(blob["rings"])).items()}}


def _reference(specs, feed, rounds):
    ref = ShardedEngine(staleness=2, device="cpu")
    uids = [ref.admit(JobSpec(**s)) for s in specs]
    ticks = [ref.tick([(u, f[t]) for u, f in zip(uids, feed)]) for t in range(rounds)]
    return [[r[u]["cohort"] for r in ticks] for u in uids]


def kill_restore_case(work_dir):
    """Case (b), JAX's kill/restore bar behind a ``SelectionServer``."""
    rng = np.random.default_rng(7)
    specs = [dict(s, rounds=KILL_ROUNDS) for s in ACCEPT_SPECS]
    feed = [[lags(rng, s["K"]) for _ in range(KILL_ROUNDS)] for s in specs]
    want = _reference(specs, feed, KILL_ROUNDS)
    lap("kill_restore_case: its uninterrupted reference")
    ckpt_dir = os.path.join(work_dir, "kill")
    got = {0: [], 1: []}
    srv = SelectionServer(ShardedEngine(staleness=2, device="cpu"), ckpt_dir=ckpt_dir)
    with srv:
        with ServeClient.connect(srv.address, timeout=TIMEOUT) as c:
            jobs = [c.admit(**s) for s in specs]
            for t in range(KILL_SPLIT):
                for i, j in enumerate(jobs):
                    out = c.tick(j, lags=feed[i][t])
                    got[i].append((out["round"], out["cohort"]))
            c.checkpoint()
        srv.kill()  # a crash: no drain, no final checkpoint
    engine, step = load_server(latest_server_checkpoint(ckpt_dir), device="cpu")
    with SelectionServer(engine, ckpt_dir=ckpt_dir) as srv2, \
            ServeClient.connect(srv2.address, timeout=TIMEOUT) as c:
        for t in range(KILL_SPLIT, KILL_ROUNDS):
            for i, j in enumerate(jobs):
                out = c.tick(j, lags=feed[i][t])
                got[i].append((out["round"], out["cohort"]))
    return {"kill/step": np.array(step),
            **{f"kill/rounds{i}": np.array([r for r, _ in got[i]]) for i in range(2)},
            **{f"kill/same{i}": np.array([c for _, c in got[i]] == want[i]) for i in range(2)}}


def chaos_case(work_dir):
    """Case (b), JAX's chaos bar: the crashed engine is freed by reference
    counting alone as the restored one takes over."""
    rng = np.random.default_rng(29)
    specs = [dict(s, rounds=CHAOS_ROUNDS) for s in CHAOS_SPECS]
    feed = [[lags(rng, s["K"]) for _ in range(CHAOS_ROUNDS)] for s in specs]
    want = _reference(specs, feed, CHAOS_ROUNDS)
    lap("chaos_case: its uninterrupted reference")
    plan = FaultPlan(crash_steps=(25,), corrupt_checkpoints=(3,), drop_responses=(12, 31), slow_steps={5: 0.02})
    srv = SelectionServer(ShardedEngine(staleness=2, device="cpu"), ckpt_dir=os.path.join(work_dir, "chaos"),
                          ckpt_every=6, faults=plan, restart_backoff=0.01)
    crashed = weakref.ref(srv.engine)
    gc.collect()
    gc.disable()
    try:
        with srv, ServeClient.connect(srv.address, timeout=TIMEOUT, retries=6, seed=5) as c:
            jobs = [c.admit(**s) for s in specs]
            cursors, got = {i: 0 for i in range(2)}, {i: {} for i in range(2)}
            while any(t < CHAOS_ROUNDS for t in cursors.values()):
                for i, j in enumerate(jobs):
                    t = cursors[i]
                    if t >= CHAOS_ROUNDS:
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
            freed = crashed() is None
    finally:
        gc.enable()
    restart = [a for a in srv.alerts if a.rule == "engine_restart"]
    return {"chaos/fired": np.array(json.dumps(plan.fired(), sort_keys=True)),
            "chaos/restarts": np.array(stats["restarts"]), "chaos/replayed": np.array(stats["replayed"]),
            "chaos/restored_step": np.array([a.detail["restored_step"] for a in restart]),
            "chaos/stem": np.array(restart[0].detail["checkpoint"] if restart else ""),
            "chaos/series_restarts": np.array(srv.serve_series()["restarts"].sum()),
            "chaos/crashed_freed": np.array(freed),
            **{f"chaos/rounds{i}": np.array(sorted(got[i])) for i in range(2)},
            **{f"chaos/same{i}": np.array([got[i].get(t) for t in range(CHAOS_ROUNDS)] == want[i])
               for i in range(2)}}


def guard_case(D):
    """Case (c): a -inf weight planted (through ``load_arrays``) in the last
    rank's slab of job 0 refuses the tick on every rank; every rank's state,
    rings and streams stay as they were, and job 1 then ticks.  -inf stays
    on its rank (its weight is 0, the max over the ranks is finite), so only
    that rank's update is non-finite: a guard that read only its own slab
    would let the other ranks commit."""
    rng = np.random.default_rng(11)
    eng = ShardedEngine(staleness=2, device="cpu")
    uids = [eng.admit(JobSpec(K=K_SH, k=k_SH, rounds=12, seed=s)) for s in (41, 42)]
    for _ in range(2):
        eng.tick([(u, lags(rng, K_SH)) for u in uids])
    arrays = eng.arrays()
    client = K_SH - 3  # in the last rank's slab
    arrays[str(uids[0])]["state"].e3cs.logw[client] = float("-inf")
    eng.load_arrays(arrays)
    planted = eng.arrays()
    refused = False
    try:
        eng.tick([(u, lags(rng, K_SH)) for u in uids])
    except NumericsError:
        refused = True
    after, rounds = eng.arrays(), [eng.job_round(u) for u in uids]
    out = eng.tick([(uids[1], lags(rng, K_SH))])[uids[1]]
    return {"guard/refused": np.array(refused), "guard/untouched": np.array(_same(planted, after)),
            "guard/planted": np.array(bool(torch.isneginf(planted[str(uids[0])]["state"].e3cs.logw[client]))),
            "guard/rounds": np.array(rounds), "guard/next_round": np.array(out["round"]),
            "guard/next_k": np.array(len(set(out["cohort"])))}


def checkpoint_case(D, work_dir):
    """Case (d): a checkpoint of two jobs after 5 of 10 ticks restores at D
    and continues bit for bit, every array and every rank's stream equal to
    the uninterrupted engine's at the end."""
    rng = np.random.default_rng(13)
    specs = [JobSpec(K=K_SH, k=k_SH, rounds=12, seed=17), JobSpec(K=192, k=8, rounds=12, seed=23)]
    feed = [[lags(rng, s.K) for s in specs] for _ in range(10)]
    ref = ShardedEngine(staleness=2, device="cpu")
    uref = [ref.admit(s) for s in specs]
    want = [ref.tick(list(zip(uref, f))) for f in feed]
    want_arrays = ref.arrays()
    eng = ShardedEngine(staleness=2, device="cpu")
    uids = [eng.admit(s) for s in specs]
    for f in feed[:5]:
        eng.tick(list(zip(uids, f)))
    stem = save_server(os.path.join(work_dir, f"ckpt_d{D}"), eng, step=10)
    meta = eng.meta()
    eng2, step = load_server(stem, device="cpu")
    same_meta = eng2.meta() == meta
    got = [eng2.tick(list(zip(uids, f))) for f in feed[5:]]
    own = want_arrays[str(uids[0])]["key"][0]
    return {"ckpt/step": np.array(step), "ckpt/same_meta": np.array(same_meta),
            "ckpt/same_ticks": np.array(got == want[5:]), "ckpt/same_arrays": np.array(_same(eng2.arrays(),
                                                                                            want_arrays)),
            "ckpt/own_streams": np.array(own.shape[0]), "ckpt/streams_differ": np.array(not torch.equal(own[0],
                                                                                                       own[-1])),
            "ckpt/stem": np.array(stem)}


def restore_elsewhere_case(stem):
    """Case (d), the other half: a stem written at another D is refused."""
    try:
        load_server(stem, device="cpu")
    except ValueError as e:
        return {"elsewhere/error": np.array(str(e))}
    return {"elsewhere/error": np.array("")}


def jax_job_case(npz_path):
    """Case (e): a JAX ``ShardedEngine`` job's arrays (made in the parent)
    carried into this group's engine by ``sharded_job_from_jax``; the
    engine's whole arrays come back, and one tick goes through."""
    a = np.load(npz_path)
    meta = json.loads(str(a["meta"]))
    eng = engine_from_meta(meta, device="cpu")
    uid = meta["jobs"][0]["uid"]
    ns = types.SimpleNamespace
    st = ns(e3cs=ns(logw=a["logw"]), t=a["t"], sel_counts=a["sel_counts"], loss_cache=a["loss_cache"],
            vol_state=a["vol_state"], cep=a["cep"], succ_hist=a["succ_hist"],
            ucb=ns(succ=a["ucb_succ"], pulls=a["ucb_pulls"], t=a["ucb_t"]))
    sharded_job_from_jax(eng, uid, {"state": st, "rings": (a["credit"],)})
    blob = eng.arrays()[str(uid)]
    named = state_to_numpy(blob["state"], tuple(blob["rings"]))
    rnd, meta = eng.job_round(uid), eng.meta()
    out = eng.tick([(uid, lags(np.random.default_rng(5), K_SH))])[uid]
    return {**{f"jax/{n}": v for n, v in named.items()}, "jax/meta": np.array(json.dumps(meta)),
            "jax/round": np.array(rnd), "jax/next_round": np.array(out["round"]),
            "jax/next_k": np.array(len(set(out["cohort"])))}


def cli_case(mesh, work_dir, flags):
    """Case (f): ``select_serve.main`` on every rank; rank 0's report."""
    from repro_torch.launch import select_serve

    os.environ["REPRO_RESULTS"] = os.path.join(work_dir, "results")
    os.environ.pop("REPRO_BENCH_OUT", None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        select_serve.main(["--serve", "--smoke", "--mesh", str(mesh.size), "--device", "cpu", *flags])
    out = buf.getvalue()
    if mesh.rank:
        return {}
    return {f"cli/{'chaos' if flags else 'plain'}": np.array(out[out.index("\n{") + 1:])}


def serve_mesh_rank(mesh, work_dir, jax_npz=None, d4_stem=None):
    work_dir = str(work_dir)
    res = {}

    def case(name, fn, *args):  # each case's seconds on this rank (``lap``)
        res.update(fn(*args))
        lap(name)

    for S, feedback in RUNNER_CASES:  # every rank: the reference of case (a)
        case(f"runner_case S{S}/{feedback}", runner_case, mesh, S, feedback)
    if mesh.rank == 0:
        try:
            for S, feedback in RUNNER_CASES:
                case(f"engine_case S{S}/{feedback}", engine_case, S, feedback)
            case("guard_case", guard_case, mesh.size)
            case("checkpoint_case", checkpoint_case, mesh.size, work_dir)
            if d4_stem is not None:
                case("restore_elsewhere_case", restore_elsewhere_case, d4_stem)
            if jax_npz is not None:
                case("jax_job_case", jax_job_case, jax_npz)
            if mesh.size == 4:
                case("kill_restore_case", kill_restore_case, work_dir)
                case("chaos_case", chaos_case, work_dir)
        finally:
            stop_followers()
            lap("stop_followers")
    else:
        last = follow(device="cpu")
        res["follower/last_jobs"] = np.array(len(last.jobs) if last is not None else -1)
        lap("follow (the leader's cases)")
    if mesh.size == 2:
        for flags in ([], ["--chaos", "3"]):
            case(f"cli_case {' '.join(flags) or 'plain'}", cli_case, mesh, work_dir, flags)
    return res


def _groups_left() -> int:
    """The process groups this rank still has registered."""
    return len(torch.distributed.distributed_c10d._world.pg_map)


def teardown_rank(mesh, seed):
    """One engine's whole life on the group, then the rank returns (the
    harness destroys the default group and the process exits): rank 0 builds
    a ``ShardedEngine``, admits one job, ticks it once and stops the
    followers; the others follow.  Rank 0 returns the cohort and whether the
    control channel's group object was freed, a follower the jobs its last
    engine held; every rank the process groups it has left (the default
    one alone: a gloo group alive at interpreter exit can abort the rank
    there)."""
    if mesh.rank == 0:
        try:
            eng = ShardedEngine(device="cpu")
            uid = eng.admit(JobSpec(K=K_SH, k=k_SH, seed=seed))
            cohort = eng.tick([(uid, lags(np.random.default_rng(seed), K_SH))])[uid]["cohort"]
            channel = weakref.ref(engines._CHANNEL[1].group)
        finally:
            stop_followers()
        gc.collect()
        return {"cohort": np.array(cohort), "channel_freed": np.array(channel() is None),
                "groups_left": np.array(_groups_left())}
    return {"jobs": np.array(len(follow(device="cpu").jobs)), "groups_left": np.array(_groups_left())}

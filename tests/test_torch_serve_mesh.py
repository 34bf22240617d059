"""The sharded serving engine on D > 1 ranks: ``ShardedEngine`` led by rank
0, the other ranks in ``follow``, over spawned gloo groups of 2 and 4 ranks
(one spawn a D runs all of its cases; the ranks' side is
``torch_serve_mesh_ranks``, which imports no JAX).

* **(a)** The engine's ticks equal the port's own mesh runner horizon at the
  same D, bit for bit: cohorts, ``on_time``, ``stale``, the final state and
  rings; sync, S = 2 deadline and S = 2 late credit.
* **(b)** The JAX package's two acceptance bars (``tests/test_serve.py``:
  the same specs, feeds, fault plan and split) at D = 4 behind a
  ``SelectionServer`` on rank 0: every cohort equals an uninterrupted D = 4
  engine's, and chaos recovery walks back to step 18.
* **(c)** A non-finite weight in a follower's slab refuses the tick on
  every rank and leaves every rank's state as it was.
* **(d)** A checkpoint restores at its own D and continues bit for bit,
  every rank's own stream included; a D = 4 stem is refused on two ranks.
* **(e)** A JAX ``ShardedEngine(D=4)`` job after 3 ticks carries into the
  port's D = 4 engine with every named array equal; ``meta()`` has JAX's
  keys.
* **(f)** ``select_serve.main(["--serve", "--smoke", "--mesh", "2", ...])``
  on two ranks, plain and under ``--chaos 3``, serves its whole horizon.
* **(g)** Several D = 4 groups at once, each through one engine's life
  (build, tick, ``stop_followers``): every rank exits 0.
"""
import json

import numpy as np
import pytest

import torch_serve_mesh_ranks as ranks
from repro.serve import JobSpec as JJobSpec
from repro.serve import ShardedEngine as JShardedEngine
from test_torch_mesh import spawn_groups


@pytest.fixture(scope="module")
def jax_job(tmp_path_factory):
    """The JAX side of case (e): a ``ShardedEngine(D=4, staleness=2)`` job
    ticked 3 times on conftest's forced host devices, as named numpy arrays
    (``repro_torch.convert``'s names) and its ``meta()``."""
    rng = np.random.default_rng(5)
    jeng = JShardedEngine(D=4, staleness=2)
    uid = jeng.admit(JJobSpec(K=ranks.K_SH, k=ranks.k_SH, rounds=10, seed=3))
    for _ in range(3):
        jeng.tick([(uid, ranks.lags(rng, ranks.K_SH))])
    job = jeng.arrays()[str(uid)]
    st = job["state"]
    named = {"logw": st.e3cs.logw, "t": st.t, "sel_counts": st.sel_counts, "loss_cache": st.loss_cache,
             "vol_state": st.vol_state, "cep": st.cep, "succ_hist": st.succ_hist, "ucb_succ": st.ucb.succ,
             "ucb_pulls": st.ucb.pulls, "ucb_t": st.ucb.t, "credit": job["rings"][0]}
    named = {n: np.asarray(v) for n, v in named.items()}
    path = tmp_path_factory.mktemp("jax_job") / "job.npz"
    np.savez(path, meta=np.array(json.dumps(jeng.meta())), **named)
    return str(path), named, jeng.meta()


@pytest.fixture(scope="module")
def d4(jax_job, tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_mesh4")
    return spawn_groups([(ranks.serve_mesh_rank, 4, out, str(out / "work"), jax_job[0])])[0][0]


@pytest.fixture(scope="module")
def d2(d4, tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_mesh2")
    return spawn_groups([(ranks.serve_mesh_rank, 2, out, str(out / "work"), None, str(d4["ckpt/stem"]))])[0][0]


@pytest.fixture(params=[2, 4], ids=["D2", "D4"])
def rank0(request):
    """Rank 0's results of the group of ``D`` ranks."""
    return request.getfixturevalue(f"d{request.param}")


@pytest.mark.parametrize("case", [f"S{S}/{fb}" for S, fb in ranks.RUNNER_CASES])
def test_engine_ticks_equal_the_mesh_runner(rank0, case):
    eng, run = f"engine/{case}", f"runner/{case}"
    np.testing.assert_array_equal(rank0[f"{eng}/rounds"], np.arange(ranks.T_SH))
    np.testing.assert_array_equal(rank0[f"{eng}/cohorts"], rank0[f"{run}/cohorts"])
    np.testing.assert_array_equal(rank0[f"{eng}/sums"].view(np.int32), rank0[f"{run}/sums"].view(np.int32))
    names = sorted(n[len(run) + 7:] for n in rank0 if n.startswith(f"{run}/state/"))
    assert {"logw", "sel_counts", "cep"} <= set(names) and ("credit" in names) == (not case.startswith("S0"))
    assert ("fb" in names) == case.endswith("late_credit")
    for n in names:
        a, b = rank0[f"{eng}/state/{n}"], rank0[f"{run}/state/{n}"]
        assert a.dtype == b.dtype and a.shape == b.shape, n
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8), np.atleast_1d(b).view(np.uint8), err_msg=n)


def test_a_followers_nonfinite_weight_refuses_the_tick_on_every_rank(rank0):
    assert rank0["guard/planted"] and rank0["guard/refused"] and rank0["guard/untouched"]
    np.testing.assert_array_equal(rank0["guard/rounds"], [2, 2])
    assert int(rank0["guard/next_round"]) == 2 and int(rank0["guard/next_k"]) == ranks.k_SH


def test_a_checkpoint_restores_at_its_own_d_and_continues(rank0):
    assert int(rank0["ckpt/step"]) == 10 and rank0["ckpt/same_meta"]
    assert rank0["ckpt/same_ticks"] and rank0["ckpt/same_arrays"]
    # every rank's own generator state rides the checkpoint, stacked (D, ...)
    assert int(rank0["ckpt/own_streams"]) in (2, 4) and rank0["ckpt/streams_differ"]


def test_a_d4_checkpoint_is_refused_on_two_ranks(d2):
    err = str(d2["elsewhere/error"])
    assert "D=4" in err and "2 ranks" in err


def test_a_jax_d4_jobs_state_carries_in(jax_job, d4):
    _, named, jmeta = jax_job
    for n, v in named.items():
        got = d4[f"jax/{n}"]
        assert got.shape == v.shape, n
        np.testing.assert_array_equal(got, v, err_msg=n)
    meta = json.loads(str(d4["jax/meta"]))
    assert set(meta) == set(jmeta) and meta["D"] == jmeta["D"] == 4
    assert meta["jobs"] == jmeta["jobs"]
    assert int(d4["jax/round"]) == 3 and int(d4["jax/next_round"]) == 3 and int(d4["jax/next_k"]) == ranks.k_SH


def test_kill_and_restore_at_d4_is_bit_identical(d4):
    assert int(d4["kill/step"]) == 2 * ranks.KILL_SPLIT
    for i in range(2):
        np.testing.assert_array_equal(d4[f"kill/rounds{i}"], np.arange(ranks.KILL_ROUNDS))
        assert d4[f"kill/same{i}"], f"job {i} diverged"


def test_the_chaos_plan_at_d4_is_bit_identical_and_recovers_from_step_18(d4):
    assert json.loads(str(d4["chaos/fired"])) == {"crash": 1, "corrupt": 1, "drop": 2, "slow": 1}
    assert int(d4["chaos/restarts"]) == 1 and int(d4["chaos/replayed"]) >= 1
    np.testing.assert_array_equal(d4["chaos/restored_step"], [18])
    assert str(d4["chaos/stem"]).endswith("ckpt_00000018") and float(d4["chaos/series_restarts"]) == 1
    assert d4["chaos/crashed_freed"]
    for i in range(2):
        np.testing.assert_array_equal(d4[f"chaos/rounds{i}"], np.arange(ranks.CHAOS_ROUNDS))
        assert d4[f"chaos/same{i}"], f"job {i} diverged"


@pytest.mark.parametrize("mode", ["plain", "chaos"])
def test_the_command_line_serves_on_two_ranks(d2, mode):
    report = json.loads(str(d2[f"cli/{mode}"]))
    assert report["engine"] == "sharded" and report["n_admitted"] == 4
    assert report["n_ticks"] >= 40 and report["rounds_served"] >= 40
    if mode == "chaos":
        assert report["fired"] == {"crash": 1, "corrupt": 1, "drop": 2, "slow": 1} and report["restarts"] == 1
    else:
        assert report["n_restarts"] == 0 and report["n_errors"] == 0


def test_d4_groups_exit_zero_after_an_engines_life(tmp_path):
    """A few D = 4 groups at once, each building an engine, ticking once and
    stopping its followers: every rank exits 0, and the control channel's
    group is destroyed on every rank (and freed on the leader) before the
    default group is, so none of its gloo workers is left running at the
    interpreter's exit."""
    groups = spawn_groups([(ranks.teardown_rank, 4, tmp_path / f"group{g}", g) for g in range(3)])
    for res in groups:
        assert len(res[0]["cohort"]) == ranks.k_SH and bool(res[0]["channel_freed"])
        assert [int(r["jobs"]) for r in res[1:]] == [1, 1, 1]
        assert [int(r["groups_left"]) for r in res] == [1, 1, 1, 1]

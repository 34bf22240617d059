"""The int-seed drivers on the JAX package's keys: each takes the same
``seed`` as its JAX twin and builds the same keys (``core.prng``), so the
same call gives JAX's cohorts, masks, counts, packed bytes and tokens, on
the CPU at small size (K <= 1000, T <= 20).

Exact: masks, lags, counts, packed bytes, on-time and stale counts, tap
counters and generated tokens.  The harness's metrics are float32
reductions of equal masks: counts and CEP exactly, the rest within
``RTOL_METRIC`` (``tests/test_torch_fairness.py``).  Gumbel rows equal
JAX's up to the last bit of a ``log``; no cohort here has two clients that
close at its k-th score.  The scenarios are ones whose rates are float32
products and sums in JAX's order (Markov, flash crowd, the paper's classes),
so their bits are JAX's exactly (the diurnal ``sin`` may differ by an ulp,
``tests/test_torch_scenarios.py``).
"""
import json
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.engine.scan_sim as jsim
import repro.launch.select_serve as jselect_serve
import repro.scenarios as J
from repro.core.volatility import CompletionLag as JCompletionLag
from repro.engine.sharded import sharded_selection_sim as jsharded_selection_sim
from repro.launch import serve as jserve
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
import repro_torch.scenarios as P
from repro_torch.core import prng
from repro_torch.core.volatility import CompletionLag
from repro_torch.engine import async_selection_sim, scan_selection_sim, sharded_selection_sim
from repro_torch.launch import make_host_mesh, select_serve
from repro_torch.launch import serve
from repro_torch.scenarios import harness

K, k, T, SEED = 256, 8, 8, 0
RTOL_METRIC = 1e-5


@pytest.fixture(scope="module")
def gloo1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_host_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def _equal(got, want, keys):
    for key in keys:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("scheme", ["e3cs", "random", "fedcs", "pow_d"])
def test_scan_selection_sim_equals_jax(scheme):
    kw = dict(K=K, k=k, T=T, seed=SEED, frac=0.5, volatility="markov")
    got = scan_selection_sim(scheme, **kw, device="cpu")
    _equal(got, jsim.scan_selection_sim(scheme, **kw), ("masks", "xs", "counts"))


def test_async_selection_sim_equals_jax():
    kw = dict(K=K, k=k, T=T, seed=SEED, frac=0.5, staleness=2)
    got = async_selection_sim("e3cs", **kw, device="cpu")
    _equal(got, jsim.async_selection_sim("e3cs", **kw), ("masks", "lags", "arrived", "on_time", "stale",
                                                          "sel_counts"))


def test_sharded_selection_sim_equals_jax_at_one_rank(gloo1):
    kw = dict(K=K, k=k, T=T, seed=SEED, frac=0.5, volatility="markov", block=4)
    got = sharded_selection_sim("e3cs", gloo1, **kw)
    _equal(got, jsharded_selection_sim("e3cs", jmake_host_mesh(1), **kw), ("masks", "xs", "counts"))


@pytest.mark.parametrize("scenario", ["markov", "flash_crowd"])
def test_record_traces_equal_jax(scenario):
    vol, _ = P.make_scenario(scenario, K, T, SEED, device="cpu")
    jvol, _ = J.make_scenario(scenario, K, T, SEED)
    np.testing.assert_array_equal(P.record_trace(vol, T, seed=5, chunk=5, device="cpu"),
                                  np.asarray(J.record_trace(jvol, T, seed=5, chunk=5)))
    lags = P.record_lag_trace(CompletionLag(vol, max_lag=2), T, seed=6, device="cpu")
    np.testing.assert_array_equal(lags, np.asarray(J.record_lag_trace(JCompletionLag(jvol, max_lag=2), T, seed=6)))


def test_run_replay_equals_jax():
    rows, packed = harness.run_replay(("e3cs", "fedcs", "ucb"), "markov", K=K, k=k, T=T, seed=SEED, device="cpu")
    jrows, jpacked = J.run_replay(("e3cs", "fedcs", "ucb"), "markov", K=K, k=k, T=T, seed=SEED)
    np.testing.assert_array_equal(packed, np.asarray(jpacked))
    for row, jrow in zip(rows, jrows):
        assert row["cep"] == jrow["cep"], row["selector"]
        for key in ("eff_participation", "jain", "entropy"):
            np.testing.assert_allclose(row[key], jrow[key], rtol=RTOL_METRIC, err_msg=key)


def test_the_replay_cell_shares_its_keys_with_the_recording():
    """The reference's caveat, copied: ``run_replay`` records and selects
    from one seed, so round ``t``'s recorded row and E3CS's Gumbel row come
    from one key, ``fold_in(key_t, 1)``, ``key_t`` the key both carry after
    ``t`` rounds."""
    vol, rho = P.make_scenario("paper_iid", K, T, SEED, device="cpu")
    _, packed = harness.run_replay("e3cs", "paper_iid", K=K, k=k, T=T, seed=SEED, device="cpu")
    out = scan_selection_sim("e3cs", K=K, k=k, T=T, seed=SEED, rho=rho, packed_override=packed, device="cpu")
    key = prng.PRNGKey(SEED, "cpu")
    for t in range(T):
        key, shared = prng.split(key)
        u = prng.uniform(shared, (K,))
        np.testing.assert_array_equal(P.unpack_trace(packed[t], K), (u < rho).float().numpy())
        scores = torch.log(torch.clamp(torch.from_numpy(out["ps"][t]), min=1e-20)) + prng.gumbel(shared, (K,))
        cohort = np.sort(torch.topk(scores, k).indices.numpy())
        np.testing.assert_array_equal(cohort, np.nonzero(out["masks"][t])[0])


def test_harness_cell_equals_jax():
    kw = dict(K=K, k=k, T=T, seed=SEED, staleness=2)
    row = harness.evaluate_cell("e3cs", "flash_crowd", **kw, device="cpu")
    jrow = J.evaluate_cell("e3cs", "flash_crowd", **kw)
    assert set(row) >= set(jrow)
    for key, want in jrow.items():
        if key in ("cep", "async_cep", "lc_cep", "selector", "scenario", "K", "k", "T"):
            assert row[key] == want, key
        else:
            np.testing.assert_allclose(row[key], want, rtol=RTOL_METRIC, atol=1e-6, err_msg=key)


def test_run_grid_multi_job_equals_jax():
    scenarios = ("paper_iid", "markov", "flash_crowd")
    rows = harness.run_grid_multi_job(scenarios, K=K, k=k, T=T, seed=SEED, device="cpu")
    jrows = J.run_grid_multi_job(scenarios, K=K, k=k, T=T, seed=SEED)
    for row, jrow in zip(rows, jrows):
        assert row["cep"] == jrow["cep"], row["scenario"]
        for key in ("jain", "entropy"):
            np.testing.assert_allclose(row[key], jrow[key], rtol=RTOL_METRIC, err_msg=key)


def _record_cohorts(module, monkeypatch, sink):
    """Wrap ``module.make_multi_job`` so the batched step's cohorts land in
    ``sink`` (the service's report holds none)."""
    make = module.make_multi_job

    def make_recording(*a, **kw):
        job_step, batched = make(*a, **kw)

        def recording(*args):
            state, out = batched(*args)
            sink.append(np.asarray(out["idx"]))
            return state, out

        return job_step, recording

    monkeypatch.setattr(module, "make_multi_job", make_recording)


@pytest.mark.parametrize("scenario", [None, "flash_crowd"])
def test_run_service_cohorts_equal_jax(monkeypatch, scenario):
    kw = dict(J=3, K_max=600, rounds=5, seed=SEED, scenario=scenario)
    got, want = [], []
    _record_cohorts(select_serve, monkeypatch, got)
    _record_cohorts(jselect_serve, monkeypatch, want)
    select_serve.run_service(**kw, device="cpu")
    jselect_serve.run_service(**kw)
    assert len(got) == len(want) == 6  # the warm-up dispatch, then a tick a round
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("staleness", [0, 2])
def test_run_service_compiled_counts_equal_jax(staleness):
    kw = dict(J=3, K_max=600, rounds=6, seed=SEED, staleness=staleness, reps=1)
    rep = select_serve.run_service_compiled(**kw, device="cpu")
    jrep = jselect_serve.run_service_compiled(**kw)
    for key in ("on_time_total", "stale_credit_total", "cohort_sizes", "populations"):
        assert rep[key] == jrep[key], key


@pytest.mark.parametrize("staleness", [0, 2])
def test_run_service_sharded_equals_jax(gloo1, tmp_path, monkeypatch, staleness):
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path))
    kw = dict(K=1000, rounds=8, D=1, block=4, reps=1, staleness=staleness, fused=True)
    rep = select_serve.run_service_sharded(**kw, device="cpu")
    jrep = jselect_serve.run_service_sharded(**kw)
    assert rep["tap_counters"] == {n: float(v) for n, v in jrep["tap_counters"].items()}


def test_serve_main_tokens_equal_jax(capsys, monkeypatch):
    """``launch.serve.main`` at smoke size, sampled, one prompt: parameters,
    prompt and decode keys all from ``--seed``; every generated token (the
    printout holds all 12) JAX's."""
    argv = ["--arch", "llama3-405b", "--smoke", "--batch", "1", "--prompt-len", "8", "--gen", "11",
            "--temperature", "0.8", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    capsys.readouterr()
    jserve.main()
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    line = serve.main(argv + ["--device", "cpu"])
    assert line["generated_shape"] == printed["generated_shape"] == [1, 12]
    assert line["sample_tokens"] == printed["sample_tokens"]

"""The selection service of the port against the JAX package's.

The fleet job ``run_service_sharded`` on a one-rank gloo group at a small
K, against JAX's on one CPU device: the same report keys and tap counters,
the same metric streams, and a run log that validates under both packages.
The two draw different noise, so their alerts may differ; a cohort-size
alert may not fire in either.

The multi-job service (``run_service``, ``run_service_compiled``) on JAX's
standard fleet at a small K_max: JAX's report keys and its deterministic
fields (jobs, populations, cohort sizes, ticks, modes), and the command
line's smoke runs on the CPU, the socket server's (``--serve --smoke``, with
and without ``--chaos``) among them.  Rates and totals depend on the noise,
which differs between the packages."""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.launch.select_serve as jserve
import repro.obs as jobs
from repro.launch.select_serve import run_service_sharded as jrun_service_sharded
from repro_torch import obs
from repro_torch.launch import select_serve
from repro_torch.launch.select_serve import run_service_sharded

K, ROUNDS = 4096, 10


@pytest.fixture(scope="module")
def gloo1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("staleness", [0, 2])
def test_fleet_job_matches_the_jax_report(gloo1, tmp_path, monkeypatch, staleness):
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path))
    monkeypatch.delenv("REPRO_BENCH_OUT", raising=False)
    kw = dict(K=K, rounds=ROUNDS, D=1, block=4, reps=1, staleness=staleness, fused=True)
    rep, jrep = obs.Reporter("fleet"), jobs.Reporter("fleet")
    report = run_service_sharded(**kw, reporter=rep, device="cpu")
    jreport = jrun_service_sharded(**kw, reporter=jrep)
    assert set(report) == set(jreport)
    for key in ("mode", "mesh_devices", "K", "k", "rounds", "bisect_block", "fused", "per_device_state_mb"):
        assert report[key] == jreport[key], key
    k = report["k"]
    counters = report["tap_counters"]
    assert set(counters) == set(jreport["tap_counters"])
    assert counters["rounds"] == ROUNDS and counters["cum_selected"] == ROUNDS * k
    assert report["rounds_per_s"] > 0 and report["client_decisions_per_s"] == pytest.approx(
        report["rounds_per_s"] * K, rel=1e-2)
    assert set(rep.metrics) == set(jrep.metrics) == {"serve_sharded", "fairness"}
    sel = rep.metrics["serve_sharded"]["aggs"]["selected"]
    assert sel["p50"] == sel["p99"] == [float(k)] * ROUNDS  # window 1: k every round
    fair = rep.metrics["fairness"]
    assert fair["n_windows"] == ROUNDS // max(1, ROUNDS // 5)
    assert all(np.isfinite(v).all() for agg in fair["aggs"].values() for v in agg.values())
    assert not any(a["rule"] == "drift" and a.get("metric") == "selected" for a in rep.data["alerts"])
    rep.save(report)
    jrep.save(jreport)
    records = obs.read_runlog(rep.log.path)
    obs.validate_records(records)
    jobs.validate_records(records)
    assert [r["event"] for r in records][:3] == ["header", "metrics", "metrics"]
    assert records[-1]["event"] == "summary"
    assert set(records[-1]["data"]) == set(jobs.read_runlog(jrep.log.path)[-1]["data"])


# -- the multi-job service: run_service, run_service_compiled and the CLI -------

J, K_MAX, TICKS = 4, 512, 6
SERVICE_FIELDS = ("jobs", "K_max", "rounds", "ticks", "cohort_sizes", "populations")


@pytest.mark.parametrize("J_", [3, 8])
def test_the_standard_fleet_is_jaxs(J_):
    a = select_serve._heterogeneous_fleet(J_, 1000, np.random.default_rng(5))
    b = jserve._heterogeneous_fleet(J_, 1000, np.random.default_rng(5))
    assert a == b


@pytest.mark.parametrize("scenario", [None, "diurnal"])
def test_run_service_matches_the_jax_report(tmp_path, monkeypatch, scenario):
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path))
    kw = dict(J=J, K_max=K_MAX, rounds=TICKS, seed=1, scenario=scenario)
    rep = obs.Reporter("serve")
    report, jreport = select_serve.run_service(**kw, reporter=rep, device="cpu"), jserve.run_service(**kw)
    assert list(report) == list(jreport) and list(report["latency_ms"]) == list(jreport["latency_ms"])
    for key in SERVICE_FIELDS + ("scenario",):
        assert report[key] == jreport[key], key
    assert report["ticks"] == J * TICKS and report["ticks_per_s"] > 0
    assert report["client_decisions_per_s"] == pytest.approx(
        report["ticks_per_s"] * sum(report["populations"]) / J, rel=1e-2)
    assert set(rep.data["hists"]) == {"request_latency", "dispatch_latency", "feedback_latency"}
    assert rep.data["hists"]["request_latency"]["count"] == J * TICKS


@pytest.mark.parametrize("staleness", [0, 2])
def test_run_service_compiled_matches_the_jax_report(tmp_path, monkeypatch, staleness):
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path))
    kw = dict(J=J, K_max=K_MAX, rounds=TICKS, seed=1, staleness=staleness, reps=1)
    rep = obs.Reporter("serve_async")
    report, jreport = select_serve.run_service_compiled(**kw, reporter=rep, device="cpu"), jserve.run_service_compiled(**kw)
    assert list(report) == list(jreport)
    for key in SERVICE_FIELDS + ("mode", "staleness", "alpha"):
        assert report[key] == jreport[key], key
    assert rep.metrics["serve_async"]["n_windows"] == TICKS // max(1, TICKS // 10)
    if staleness == 0:
        assert report["stale_credit_total"] == 0.0
    assert 0 < report["on_time_total"] <= TICKS * sum(report["cohort_sizes"])


@pytest.mark.parametrize("staleness", [0, 2])
def test_service_horizon_ticks_select_k_and_resume(staleness):
    """Each tick every job's on-time bits stay within its cohort, a horizon
    in two chunks equals one horizon, and a reset horizon repeats itself."""
    horizon, Ks, ks = select_serve._service_horizon(J, K_MAX, 2, staleness, 0.5, 0.7, 0.5, 48, 8192, "cpu")
    state, pending, on_time, stale = horizon.run(TICKS)
    assert (state.t.numpy() == TICKS).all() and (on_time.numpy() <= np.asarray(ks)).all()
    for j, Kj in enumerate(Ks):
        assert float(state.logw[j, Kj:].abs().sum()) == 0.0
    horizon.reset()
    _, _, o1, a1 = horizon.run(TICKS // 2)
    s2, p2, o2, a2 = horizon.run(TICKS - TICKS // 2)
    assert torch.equal(s2.logw, state.logw) and torch.equal(p2, pending)
    assert torch.equal(torch.cat([o1, o2]), on_time) and torch.equal(torch.cat([a1, a2]), stale)


@pytest.mark.parametrize("flags", [[], ["--async"], ["--scenario", "diurnal"], ["--mesh", "1"]],
                         ids=["default", "async", "scenario", "mesh"])
def test_the_command_line_smoke(gloo1, tmp_path, monkeypatch, capsys, flags):
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path))
    monkeypatch.delenv("REPRO_BENCH_OUT", raising=False)
    select_serve.main(["--smoke", "--device", "cpu", *flags])
    report = json.loads(capsys.readouterr().out)
    if flags == ["--mesh", "1"]:
        assert report["mode"] == "compiled_sharded" and report["K"] == 65_536
        return
    assert report["jobs"] == 4 and report["rounds"] == 10 and report["K_max"] == 512
    if flags == ["--async"]:
        assert report["mode"] == "compiled_async"
    else:
        assert report["scenario"] == ("diurnal" if flags else "paper_iid(static)")


@pytest.mark.parametrize("flags", [[], ["--chaos", "3"]], ids=["serve", "chaos"])
def test_the_command_line_serves_over_loopback(tmp_path, monkeypatch, capsys, flags):
    """``--serve --smoke``: the socket server and the built-in loopback
    client (4 jobs, 10 rounds); ``--chaos 3`` arms JAX's seeded fault plan
    for that horizon and the run completes through it."""
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path))
    monkeypatch.delenv("REPRO_BENCH_OUT", raising=False)
    select_serve.main(["--serve", "--smoke", "--device", "cpu", *flags])
    out = capsys.readouterr().out
    report = json.loads(out[out.index("\n{") + 1:])
    assert report["engine"] == "slots" and report["staleness"] == 0
    assert report["n_ticks"] >= 40 and report["n_admitted"] == 4 and report["rounds_served"] >= 40
    if flags:
        assert report["fired"] == {"crash": 1, "corrupt": 1, "drop": 2, "slow": 1} and report["restarts"] == 1
        assert report["chaos_seed"] == 3 and "chaos survived" in out
    else:
        assert report["n_restarts"] == 0 and report["n_errors"] == 0

"""The fleet job ``run_service_sharded`` of the port on a one-rank gloo group
at a small K, against the JAX package's on one CPU device: the same report
keys and tap counters, the same metric streams, and a run log that
validates under both packages.  The two draw different noise, so their
alerts may differ; a cohort-size alert may not fire in either."""
import numpy as np
import pytest
import torch.distributed as dist

import repro.obs as jobs
from repro.launch.select_serve import run_service_sharded as jrun_service_sharded
from repro_torch import obs
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

"""The port's metrics spine against the JAX package's, on the CPU.

* host side (numpy): ``window_reduce``, ``fairness_series``,
  ``merge_sketches``, ``sketch_from_dense``, ``detect_alerts``, the run log
  round trip with ``validate_records``, the ``Reporter``'s bench JSON and
  run log (under ``tmp_path`` through ``REPRO_RESULTS``) and the latency
  histogram: the same numpy inputs through both packages, equal;
* ``sketch_step`` on seeded random slabs (sync and async lags, with and
  without ``active``, on an emission round and off it): exact;
* the round's taps and sketches: the port's ``build_step`` with taps and
  sketch, fed the JAX package's Gumbel rows and the same trace rows, against
  JAX's ``build_runner(taps=True, sketch=...)``: ``selected``, the counters
  and the sketch stream exact, the float gauges within ``RTOL``.

The port's own stream properties (taps-on state equal taps-off, the stream
against ``sketch_from_dense`` of a run's outputs, the one-rank and spawned
meshes, ``carry_key`` chunks) are in ``test_torch_obs_mesh.py``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.obs.sketches import sketch_step as jsketch_step
from repro_torch import obs
from repro_torch.engine import RoundNoise
from repro_torch.obs.sketches import lag_bins, sketch_step
from test_torch_round_program import K, SEED, T, RTOL, _jax_gumbel_rows, _programs, _trace

SPEC_KW = dict(window=4, count_bins=8, prob_bins=10, n_regions=3)


def _stream(rng, n_emits=5, B=8, PB=10, R=3, L=4):
    """A random but self-consistent sketch stream (integer-valued sums)."""
    K_ = 500
    out = {
        "count_hist": rng.multinomial(K_, np.ones(B) / B, n_emits).astype(np.float64),
        "p_hist": rng.multinomial(K_, np.ones(PB) / PB, n_emits).astype(np.float64),
        "region_clients": rng.multinomial(K_, np.ones(R) / R, n_emits).astype(np.float64),
        "lag_hist": np.cumsum(rng.integers(0, 20, (n_emits, L)), axis=0).astype(np.float64),
    }
    out["count_mass"] = out["count_hist"] * (2.0 ** np.arange(B) - 1)
    out["region_selected"] = rng.integers(0, 200, (n_emits, R)).astype(np.float64)
    out["region_on_time"] = np.floor(out["region_selected"] * rng.random((n_emits, R)))
    out["sum_c"] = out["count_mass"].sum(1)
    out["sum_c2"] = (out["count_hist"] * (2.0 ** np.arange(B) - 1) ** 2).sum(1)
    return out


def _assert_trees(a, b, exact=True):
    assert set(a) == set(b)
    for n in a:
        if exact:
            np.testing.assert_array_equal(np.asarray(a[n]), np.asarray(b[n]), err_msg=n)
        else:
            np.testing.assert_allclose(np.asarray(a[n]), np.asarray(b[n]), rtol=RTOL, err_msg=n)


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------


def test_tap_registry_matches():
    assert obs.ROUND_TAPS.gauge_names(None) == jobs.ROUND_TAPS.gauge_names(None)
    for group in (None, "round", "fairness", "serve"):
        assert obs.ROUND_TAPS.directions(group) == jobs.ROUND_TAPS.directions(group)
    assert [s.name for s in obs.ROUND_TAPS.counters()] == [s.name for s in jobs.ROUND_TAPS.counters()]
    c = obs.ROUND_TAPS.init_counters("cpu")
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in c.values())
    row = {n: torch.tensor(float(i + 1)) for i, n in enumerate(obs.ROUND_TAPS.gauge_names())}
    jc = jobs.ROUND_TAPS.init_counters()
    for _ in range(3):
        c = obs.ROUND_TAPS.accumulate(c, row)
        jc = jobs.ROUND_TAPS.accumulate(jc, {n: jnp.float32(float(v)) for n, v in row.items()})
    assert {n: float(v) for n, v in c.items()} == {n: float(v) for n, v in jc.items()}
    assert obs.SKETCH_FIELDS == jobs.SKETCH_FIELDS


@pytest.mark.parametrize("window", [1, 3, 7])
def test_window_reduce_matches(window):
    rng = np.random.default_rng(window)
    series = {n: rng.normal(size=50) for n in ("on_time", "stale", "sigma")}
    assert obs.window_reduce(series, window) == jobs.window_reduce(series, window)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fairness_merge_and_dense_recompute_match(seed):
    rng = np.random.default_rng(seed)
    a, b = _stream(rng), _stream(rng)
    _assert_trees(obs.fairness_series(a), jobs.fairness_series(a))
    _assert_trees(obs.merge_sketches(a, b), jobs.merge_sketches(a, b))
    n = 300
    counts = rng.integers(0, 40, n).astype(np.float32)
    p = rng.random(n).astype(np.float32)
    cum = np.floor(counts * rng.random(n)).astype(np.float32)
    region = rng.integers(0, 3, n).astype(np.int32)
    active = (rng.random(n) < 0.9).astype(np.float32)
    for spec_kw in (SPEC_KW, dict(SPEC_KW, regions=region)):
        for act in (None, active):
            args = (counts, p, cum, np.arange(4.0), region, act)
            _assert_trees(obs.sketch_from_dense(obs.SketchSpec(**spec_kw), *args),
                          jobs.sketch_from_dense(jobs.SketchSpec(**spec_kw), *args))
    np.testing.assert_array_equal(obs.sketches.region_ids(obs.SketchSpec(n_regions=3), 10),
                                  jobs.sketches.region_ids(jobs.SketchSpec(n_regions=3), 10))


ALERT_CASES = {
    "outage": dict(series={"on_time": np.concatenate([np.full(40, 10.0), np.full(10, 1.0)])},
                   rules=dict(window=10)),
    "starvation": dict(fairness={"jain": np.array([0.9, 0.3]), "top_decile_share": np.array([0.2, 0.8])}),
    "drift": dict(series={"selected": np.array([16.0, 16.0, 15.0]), "capped_frac": np.full(10, 0.9)},
                  expected_selected=16, rules=dict(window=5)),
    "restart": dict(series={"restarts": np.array([0.0, 1.0, 0.0]), "recovery_s": np.array([0.0, 0.4, 0.0])}),
    "quiet": dict(series={"on_time": np.full(50, 10.0), "selected": np.full(50, 16.0)}, expected_selected=16),
}


@pytest.mark.parametrize("case", list(ALERT_CASES))
def test_detect_alerts_matches(case):
    kw = dict(ALERT_CASES[case])
    rules = kw.pop("rules", {})
    got = obs.detect_alerts(**kw, rules=obs.AlertRules(**rules))
    want = jobs.detect_alerts(**kw, rules=jobs.AlertRules(**rules))
    assert [(a.rule, a.severity, a.detail, a.message) for a in got] == [
        (a.rule, a.severity, a.detail, a.message) for a in want
    ]


def _strip_ts(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def test_runlog_round_trip_matches(tmp_path):
    hist, jhist = obs.LatencyHistogram(), jobs.LatencyHistogram()
    for s in np.random.default_rng(0).exponential(0.01, 200):
        hist.observe(s)
        jhist.observe(s)
    assert hist.summary() == jhist.summary()
    windows = obs.window_reduce({"v": np.arange(8.0)}, 4)
    logs = []
    for pkg, h, sub in ((obs, hist, "port"), (jobs, jhist, "jax")):
        path = str(tmp_path / sub / "run.jsonl")
        with pkg.RunLog("unit", config={"K": 4, "x": np.float32(0.5)}, path=path) as log:
            log.metrics("s1", windows, better={"v": "higher"})
            log.grid_row({"selector": "e3cs", "cep": np.float64("nan")})
            log.histogram("lat", h)
            log.alert("outage", "critical", {"window": 3}, "credit fell")
            log.summary(done=True, rate=torch.tensor(2.5) if pkg is obs else np.float32(2.5))
        records = pkg.read_runlog(path)
        pkg.validate_records(records)
        jobs.validate_records(records)
        logs.append(records)
    assert _strip_ts(logs[0]) == _strip_ts(logs[1])
    assert len(list(obs.iter_alerts(logs[0]))) == 1 and len(list(obs.iter_metrics(logs[0]))) == 1
    with pytest.raises(FileExistsError):
        obs.RunLog("unit", path=str(tmp_path / "port" / "run.jsonl"))


def test_reporter_matches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path))
    monkeypatch.delenv("REPRO_BENCH_OUT", raising=False)
    rng = np.random.default_rng(3)
    series = {n: rng.integers(0, 20, 40).astype(np.float64) for n in ("selected", "on_time", "stale")}
    sketches = _stream(rng)
    outs = []
    for pkg in (obs, jobs):
        rep = pkg.Reporter("fleet", config={"K": 7})
        rep.metrics_stream("serve_sharded", series, window=4, better=pkg.ROUND_TAPS.directions())
        fair = rep.fairness_stream("fairness", sketches)
        alerts = rep.alerts(series=series, fairness=fair, expected_selected=16)
        path = rep.save({"rounds_per_s": 12.5, "K": 7})
        outs.append((path, rep.log.path, [a.rule for a in alerts]))
    (path, log_path, rules), (jpath, jlog_path, jrules) = outs
    assert path == os.path.join(str(tmp_path), "bench", "torch", "BENCH_fleet.json")
    assert log_path == os.path.join(str(tmp_path), "runlogs", "torch", "fleet.jsonl")
    assert jpath != path and jlog_path != log_path  # the port never writes the JAX package's files
    assert rules == jrules and "drift" in rules
    with open(path) as f, open(jpath) as g:
        assert json.load(f) == json.load(g)
    assert _strip_ts(obs.read_runlog(log_path)) == _strip_ts(jobs.read_runlog(jlog_path))


def test_paths_follow_the_environment(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_RESULTS", raising=False)
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path / "b"))
    assert obs.bench_dir() == str(tmp_path / "b") == jobs.bench_dir()
    assert obs.results_root() == jobs.results_root() == str(tmp_path)
    assert obs.runlog_dir() == os.path.join(str(tmp_path), "runlogs", "torch")
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path / "r"))
    assert obs.artifact_path("g.json") == jobs.artifact_path("g.json")
    assert os.path.isdir(str(tmp_path / "r"))
    assert obs.runlog_path("x").startswith(str(tmp_path / "r" / "runlogs" / "torch"))


def test_span_timer_feeds_its_histogram():
    spans = obs.SpanTimer()
    for _ in range(3):
        with spans.span("request"):
            pass
    assert spans.hist["request"].count == 3
    assert spans.quantile("missing", 0.5) is None
    assert set(spans.summary()["request"]) == set(jobs.LatencyHistogram().summary())


# ---------------------------------------------------------------------------
# sketch_step, port against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("emit", [True, False], ids=["emission", "quiet"])
@pytest.mark.parametrize("with_active", [False, True], ids=["all", "active"])
@pytest.mark.parametrize("staleness", [None, 2], ids=["sync", "async"])
def test_sketch_step_matches_jax(staleness, with_active, emit):
    rng = np.random.default_rng(7)
    n, L = 777, lag_bins(staleness)
    spec, jspec = obs.SketchSpec(**SPEC_KW), jobs.SketchSpec(**SPEC_KW)
    mask = (rng.random(n) < 0.1).astype(np.float32)
    lag = rng.choice(np.array([-1, 0, 1, 2], np.int32), n) if staleness else None
    x = (lag == 0).astype(np.float32) if staleness else (rng.random(n) < 0.6).astype(np.float32)
    p = rng.random(n).astype(np.float32)
    p[:5] = [0.0, 1.0, 0.1, 0.9999999, 0.5]
    counts = rng.integers(0, 40, n).astype(np.float32)  # every sum stays below 2^24
    region = rng.integers(0, 3, n).astype(np.int32)
    active = (rng.random(n) < 0.8).astype(np.float32) if with_active else None
    cum = np.floor(counts * rng.random(n)).astype(np.float32)
    hist0 = rng.integers(0, 50, L).astype(np.float32)
    t = 8 if emit else 9
    tt = {n_: torch.from_numpy(v) for n_, v in dict(mask=mask, x=x, p=p, counts=counts, region=region).items()}
    got_c, got_r = sketch_step(
        spec, {"cum_on_time": torch.from_numpy(cum), "lag_hist": torch.from_numpy(hist0)}, tt["mask"], tt["x"],
        None if lag is None else torch.from_numpy(lag), tt["p"], tt["counts"], torch.tensor(t, dtype=torch.int32),
        tt["region"], None if active is None else torch.from_numpy(active), L,
    )
    want_c, want_r = jsketch_step(
        jspec, {"cum_on_time": jnp.asarray(cum), "lag_hist": jnp.asarray(hist0)}, jnp.asarray(mask), jnp.asarray(x),
        None if lag is None else jnp.asarray(lag), jnp.asarray(p), jnp.asarray(counts), jnp.int32(t),
        jnp.asarray(region), None if active is None else jnp.asarray(active), L,
    )
    _assert_trees({n_: v.numpy() for n_, v in got_c.items()}, want_c)
    _assert_trees({n_: v.numpy() for n_, v in got_r.items()}, want_r)
    assert bool(np.asarray(want_r["count_hist"]).any()) == emit


# ---------------------------------------------------------------------------
# the round's taps and sketches, port against JAX
# ---------------------------------------------------------------------------

TAP_CASES = [(None, "deadline", "dense"), (None, "deadline", "packed"), (2, "deadline", "dense"),
             (2, "late_credit", "dense"), (2, "late_credit", "packed_lags")]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
@pytest.mark.parametrize("staleness,feedback,override", TAP_CASES)
def test_round_taps_and_sketches_match_jax(staleness, feedback, override, fused):
    jpm, pm = _programs(staleness=staleness, allocator="bisect", feedback=feedback, override=override, fused=fused)
    dense, packed = _trace("dense_async" if staleness else "dense")
    rows = dense if override == "dense" else packed
    jspec, spec = jobs.SketchSpec(**SPEC_KW), obs.SketchSpec(**SPEC_KW)
    jrun, js0 = jpm.build_runner(outputs="full", taps=True, sketch=jspec)
    *_, jpay = jrun(js0, jax.random.PRNGKey(SEED), jnp.asarray(rows))
    _, gumbel = _jax_gumbel_rows(jax.random.PRNGKey(SEED), T)
    step = pm._step(False, True, spec)
    s0 = pm._state0()
    carry = (s0,) + ((pm.init_rings(),) if staleness else ()) + (
        obs.ROUND_TAPS.init_counters("cpu"), obs.sketches.sketch_carry0(K, lag_bins(staleness), "cpu"))
    gauges, sks = [], []
    for t in range(T):
        noise = RoundNoise(g=torch.from_numpy(np.array(gumbel[t])))
        carry, out = step(carry, torch.from_numpy(np.array(rows[t])), noise)
        gauges.append(out[-2])
        sks.append(out[-1])
    series = {n: np.stack([g[n].numpy() for g in gauges]) for n in gauges[0]}
    stream = {n: np.stack([s[n].numpy() for s in sks])[spec.window - 1 :: spec.window] for n in sks[0]}
    jseries = {n: np.asarray(v) for n, v in jpay["series"].items()}
    np.testing.assert_array_equal(series["selected"], jseries["selected"])
    _assert_trees(series, jseries, exact=False)
    counters = {n: float(v) for n, v in carry[-2].items()}
    assert counters["rounds"] == float(jpay["counters"]["rounds"]) == T
    assert counters["cum_selected"] == float(jpay["counters"]["cum_selected"])
    np.testing.assert_allclose(counters["cum_credit"], float(jpay["counters"]["cum_credit"]), rtol=RTOL)
    _assert_trees(stream, {n: np.asarray(v) for n, v in jpay["sketches"].items()})

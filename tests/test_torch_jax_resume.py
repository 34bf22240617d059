"""A selection service checkpointed by the JAX package, restored in the port
and continued: its stems load through ``repro_torch.serve.state.load_server``
on the JAX key stream, and the port serves the cohorts JAX's uninterrupted
server serves.

* Slot and sharded engines (the sharded one on a one-rank gloo mesh), sync
  and S = 2, two jobs: JAX ticks three rounds and saves a stem (zlib, as the
  JAX package writes without ``zstandard``), then ticks ``N`` more; the port
  loads the stem and ticks the same ``N`` rows.  Cohorts, rounds and on-time
  counts are exact (every draw is exact but the Gumbel rows, within 2e-6 of
  JAX's, and no round of these jobs has a client within that of its k-th
  score); ``stale`` within float32 sums.
* The port's own stem, saved mid-way from the restored engine, reloads on
  the JAX stream and continues the same way.
* ``checkpoint.jax_format.read`` reads a JAX file's arrays, the ones the
  JAX engine held; ``checkpoint.restore`` refuses the file and names its
  readers.
* A zstd stem with ``zstandard`` hidden raises ``ValueError`` naming the
  codec.
* ``ShardedEngine.tick`` with a wrong-length second row: JAX steps and
  commits the first job, then raises (its job stands at round 1); the port
  checks every row first and steps none (its job stands at round 0, and its
  next tick serves round 0).  The port's all-or-nothing tick is kept.
"""
import sys

import numpy as np
import pytest

import repro.checkpoint.checkpoint as jckpt
from repro.serve import JobSpec as JJobSpec
from repro.serve import ShardedEngine as JShardedEngine
from repro.serve import SlotEngine as JSlotEngine
from repro.serve import save_server as jsave_server
from repro_torch.checkpoint import jax_format, restore
from repro_torch.serve import JobSpec, ShardedEngine, load_server, save_server, validate_stem
from repro_torch.serve.state import latest_server_checkpoint
from test_torch_mesh import mesh1  # noqa: F401

K, k, N = 64, 8, 5
SPECS = [dict(K=K, k=k, seed=3, rounds=40), dict(K=48, k=6, seed=11, rounds=40, sigma_frac=0.3)]


def _rows(n, staleness, seed):
    rng = np.random.default_rng(seed)
    codes = [0, 1, 2, -1] if staleness else [0, -1]
    p = [0.5, 0.15, 0.1, 0.25] if staleness else [0.7, 0.3]
    return [[rng.choice(codes, size=s["K"], p=p).astype(np.int32) for s in SPECS] for _ in range(n)]


def _serve(engine, uids, rows):
    return [engine.tick(list(zip(uids, r))) for r in rows]


def _jax_stem(kind, staleness, tmp_path, monkeypatch, codec="zlib"):
    """A JAX engine of ``kind`` ticked three rounds, its stem, and what it
    serves for the ``N`` ticks after."""
    monkeypatch.setattr(jckpt, "_CODEC", codec)
    eng = (JSlotEngine(K_max=K, k_cap=k, staleness=staleness, buckets=(4,)) if kind == "slots"
           else JShardedEngine(D=1, staleness=staleness))
    uids = [eng.admit(JJobSpec(**s)) for s in SPECS]
    rows = _rows(3 + N, staleness, seed=7)
    _serve(eng, uids, rows[:3])
    stem = jsave_server(str(tmp_path / "jax"), eng, step=3)
    return stem, uids, rows[3:], _serve(eng, uids, rows[3:])


def _assert_served(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for uid in w:
            assert g[uid]["round"] == w[uid]["round"] and g[uid]["cohort"] == list(w[uid]["cohort"])
            assert g[uid]["on_time"] == w[uid]["on_time"]
            np.testing.assert_allclose(g[uid]["stale"], w[uid]["stale"], rtol=1e-6)


CASES = [("slots", 0), ("slots", 2), ("sharded", 0), ("sharded", 2)]


@pytest.mark.parametrize("kind,staleness", CASES, ids=[f"{k}-S{s}" for k, s in CASES])
def test_a_jax_stem_continues_in_the_port(kind, staleness, tmp_path, monkeypatch, request):
    if kind == "sharded":
        request.getfixturevalue("mesh1")
    stem, uids, rows, want = _jax_stem(kind, staleness, tmp_path, monkeypatch)
    assert validate_stem(stem) and latest_server_checkpoint(str(tmp_path / "jax")) == stem
    eng, step = load_server(stem, device="cpu")
    assert step == 3 and eng.stream == "jax" and eng.meta()["stream"] == "jax"
    assert [eng.job_round(u) for u in uids] == [3, 3]
    got = _serve(eng, uids, rows[:2])
    mine = save_server(str(tmp_path / "port"), eng, step=5)
    got += _serve(eng, uids, rows[2:])
    _assert_served(got, want)
    again, step = load_server(mine, device="cpu")
    assert step == 5 and again.stream == "jax"
    _assert_served(_serve(again, uids, rows[2:]), want[2:])
    if kind == "slots":  # a job admitted after the restore follows the engine's stream
        assert again.base_keys[again.jobs[again.admit(JobSpec(K=K, k=k, seed=5))]["slot"]].tolist() == [0, 5]


def test_a_jax_file_reads_through_jax_format_and_restore_refuses_it(tmp_path, monkeypatch):
    stem, _, _, _ = _jax_stem("slots", 2, tmp_path, monkeypatch)
    _, got = jax_format.read(stem + ".ckpt")
    eng, _ = load_server(stem, device="cpu")
    assert sorted(got) == sorted(eng.arrays())
    for name in ("logw", "pending", "t"):
        assert np.array_equal(got[name], eng.arrays()[name].numpy()), name
    assert np.array_equal(got["base_keys"].view(np.int32), eng.arrays()["base_keys"].numpy())
    with pytest.raises(ValueError, match="jax_format.read.*load_server"):
        restore(stem + ".ckpt", like=eng.arrays())


def test_a_zstd_stem_without_zstandard_names_the_codec(tmp_path, monkeypatch):
    pytest.importorskip("zstandard")  # the JAX package writes zstd only where it imports
    stem, _, _, _ = _jax_stem("slots", 0, tmp_path, monkeypatch, codec="zstd")
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ValueError, match="zstd"):
        load_server(stem, device="cpu")


def test_sharded_tick_with_a_wrong_row_commits_nothing_in_the_port(mesh1):  # noqa: F811
    rows = [np.zeros(64, np.int32), np.zeros(63, np.int32)]
    jeng, eng = JShardedEngine(D=1), ShardedEngine(D=1, device="cpu")
    spec = dict(K=64, k=8, seed=1)
    juids = [jeng.admit(JJobSpec(**spec)) for _ in range(2)]
    uids = [eng.admit(JobSpec(**spec)) for _ in range(2)]
    with pytest.raises(ValueError, match="63 entries"):
        jeng.tick(list(zip(juids, rows)))
    with pytest.raises(ValueError, match="63 entries"):
        eng.tick(list(zip(uids, rows)))
    assert jeng.job_round(juids[0]) == 1  # JAX stepped and committed the first job
    assert eng.job_round(uids[0]) == 0  # the port stepped none
    assert eng.tick([(uids[0], rows[0])])[uids[0]]["round"] == 0

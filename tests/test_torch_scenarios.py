"""The scenario subsystem against the JAX package's.

Trace models take the uniform rows JAX's own ``sample`` draws from its key.
Regional outages and flash crowds compare uniforms with rates built by
float32 multiplies and adds in JAX's order: bits and states are equal
exactly.  The diurnal rate passes through ``sin``, where XLA and PyTorch may
differ by an ulp: rates are held to ``ATOL_SIN`` and the bits exactly
wherever ``|u - rate| > BAND``; the test counts the draws inside the band.
The registry's numpy draws (phases, crowd, regions, deadline epochs) are
equal exactly; its rate hints (means over a period of ``sin`` rates) to
``ATOL_SIN``.  Packed bytes and the trace files are equal byte for byte.
A UCB replay is deterministic given its trace, so a streamed replay equals
JAX's exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.scenarios as J
from repro.scenarios import replay as jreplay
import repro_torch.scenarios as P
from repro_torch.core import prng
from repro_torch.core.volatility import CompletionLag, make_volatility, paper_success_rates
from repro_torch.scenarios import replay as preplay

K, T = 2048, 30
# a one-ulp difference in sin, carried through the multiply, the add and the
# clip, moves a rate by up to two ulps of its own (observed: 2 ulps at 0.83);
# four float32 ulps of a rate in [0.5, 1), absolute since rates reach 0.005
ATOL_SIN = 2.4e-7
BAND = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(name, K=K, T=T, seed=0):
    return J.make_scenario(name, K, T, seed), P.make_scenario(name, K, T, seed, device="cpu")


def test_diurnal_rate_and_bits_equal_jax_outside_the_band():
    (jvol, jrho), (vol, rho) = _models("diurnal")
    np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), rtol=0, atol=ATOL_SIN)
    key, js, s = jax.random.PRNGKey(1), jvol.init_state(), vol.init_state()
    in_band = 0
    for _ in range(T):
        key, sub = jax.random.split(key)
        rate = np.asarray(jvol.rate(js))
        np.testing.assert_allclose(vol.rate(s).numpy(), rate, rtol=0, atol=ATOL_SIN)
        u = jax.random.uniform(sub, (K,), jnp.float32)
        jx, js = jvol.sample(sub, js)
        x, s = vol.sample((_t(u),), s)
        far = np.abs(np.asarray(u) - rate) > BAND
        in_band += int((~far).sum())
        np.testing.assert_array_equal(x.numpy()[far], np.asarray(jx)[far])
        assert int(s) == int(js)
    assert in_band <= 5, in_band  # 0 of the T * K = 61,440 draws here


def test_regional_outage_equals_jax_round_for_round():
    (jvol, _), (vol, _) = _models("regional_outage")
    assert vol.draw_rows() == ((8, 0.0), (K, 0.0))
    key, js, s = jax.random.PRNGKey(2), jvol.init_state(), vol.init_state()
    for _ in range(T):
        key, sub = jax.random.split(key)
        r_reg, r_cli = jax.random.split(sub)
        us = (_t(jax.random.uniform(r_reg, (8,), jnp.float32)), _t(jax.random.uniform(r_cli, (K,), jnp.float32)))
        jx, js = jvol.sample(sub, js)
        x, s = vol.sample(us, s)
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_flash_crowd_equals_jax_through_its_window():
    (jvol, _), (vol, _) = _models("flash_crowd")
    assert (vol.t_start, vol.t_end) == (jvol.t_start, jvol.t_end) == (7, 14)
    key, js, s = jax.random.PRNGKey(3), jvol.init_state(), vol.init_state()
    for _ in range(T):
        key, sub = jax.random.split(key)
        us = tuple(_t(jax.random.uniform(r, (K,), jnp.float32)) for r in jax.random.split(sub))
        jx, js = jvol.sample(sub, js)
        x, s = vol.sample(us, s)
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(s[0].numpy(), np.asarray(js[0]))
        assert int(s[1]) == int(js[1])


@pytest.mark.parametrize("name", ["paper_iid", "markov", "markov_sticky", "deadline", "diurnal", "regional_outage",
                                  "flash_crowd"])
@pytest.mark.parametrize("seed", [0, 5])
def test_registry_arrays_equal_jax(name, seed):
    (jvol, jrho), (vol, rho) = _models(name, seed=seed)
    assert type(vol).__name__ == type(jvol).__name__
    np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), rtol=0, atol=ATOL_SIN)
    for f in ("rho", "phase", "region", "crowd", "epochs", "base_time", "p_net_fail"):
        if hasattr(jvol, f):
            np.testing.assert_array_equal(getattr(vol, f).numpy(), np.asarray(getattr(jvol, f)), err_msg=f)
    for f in ("stickiness", "period", "n_regions", "t_start", "t_end", "deadline", "amplitude"):
        if hasattr(jvol, f):
            assert getattr(vol, f) == getattr(jvol, f), f
    assert P.list_scenarios() == J.list_scenarios()


def test_unknown_scenario_raises():
    with pytest.raises(KeyError, match="unknown scenario"):
        P.make_scenario("solar_flare", 8, 8, device="cpu")


@pytest.mark.parametrize("Kp", [64, 1000, 1003])
def test_packing_is_byte_equal_to_jax(Kp):
    rng = np.random.default_rng(Kp)
    bits = (rng.random((5, Kp)) < 0.5).astype(np.float32)
    lags = rng.choice([0, 1, 2, -1], (5, Kp)).astype(np.int32)
    np.testing.assert_array_equal(P.pack_trace(bits), J.pack_trace(bits))
    np.testing.assert_array_equal(preplay.pack_bits_tensor(torch.from_numpy(bits)).numpy(),
                                  np.asarray(jreplay.pack_bits_jnp(jnp.asarray(bits))))
    np.testing.assert_array_equal(P.pack_lags(lags), J.pack_lags(lags))
    np.testing.assert_array_equal(preplay.pack_lags_tensor(torch.from_numpy(lags)).numpy(),
                                  np.asarray(jreplay.pack_lags_jnp(jnp.asarray(lags))))
    np.testing.assert_array_equal(P.unpack_trace(P.pack_trace(bits), Kp), bits)
    np.testing.assert_array_equal(P.unpack_lags(P.pack_lags(lags), Kp), J.unpack_lags(J.pack_lags(lags), Kp))
    assert P.packed_width(Kp) == J.packed_width(Kp) and P.lag_packed_width(Kp) == J.lag_packed_width(Kp)
    assert P.packed_nbytes(7, Kp) == J.packed_nbytes(7, Kp)
    with pytest.raises(ValueError, match="2-bit"):
        P.pack_lags(lags + 3)


@pytest.mark.parametrize("name", ["diurnal", "regional_outage", "flash_crowd", "markov"])
def test_record_trace_is_the_models_rounds_packed(name):
    """``record_trace`` in chunks equals one chunk, and each row is the
    model's round, drawn on the JAX package's keys from ``PRNGKey(seed)``
    (``key, k2 = split(key)`` a round, the rows from ``k2``), packed."""
    _, (vol, _) = _models(name)
    packed = P.record_trace(vol, T, seed=4, chunk=7, device="cpu")
    assert packed.shape == (T, P.packed_width(K)) and packed.dtype == np.uint8
    np.testing.assert_array_equal(packed, P.record_trace(vol, T, seed=4, chunk=T, device="cpu"))
    key, s = prng.PRNGKey(4, "cpu"), vol.init_state()
    for t in range(T):
        key, k2 = prng.split(key)
        x, s = vol.sample(vol.draw(k2), s)
        np.testing.assert_array_equal(P.unpack_trace(packed[t], K), x.numpy())


def test_record_lag_trace_checks_its_lags():
    vol = make_volatility("bernoulli", paper_success_rates(K), device="cpu")
    packed = P.record_lag_trace(CompletionLag(vol, max_lag=2), T, chunk=8, device="cpu")
    lags = P.unpack_lags(packed, K)
    assert packed.shape == (T, P.lag_packed_width(K)) and set(np.unique(lags)) <= {-1, 0, 1, 2}
    with pytest.raises(ValueError, match="max_lag=3"):
        P.record_lag_trace(CompletionLag(vol, max_lag=3), T, device="cpu")

    class TooLate:
        def to(self, device):
            return self

        def init_state(self):
            return None

        def draw(self, gen):
            return ()

        def sample(self, us, state):
            return torch.full((K,), 3, dtype=torch.int32), state

    with pytest.raises(ValueError, match="lag > 2"):
        P.record_lag_trace(TooLate(), 4, device="cpu")


def test_replay_models_equal_jax():
    rng = np.random.default_rng(6)
    bits = J.pack_trace((rng.random((T, K)) < 0.4).astype(np.float32))
    lags = J.pack_lags(rng.choice([0, 1, 2, -1], (T, K)).astype(np.int32))
    for jcls, pcls, packed in ((J.ReplayVolatility, P.ReplayVolatility, bits), (J.ReplayLag, P.ReplayLag, lags)):
        jvol, vol = jcls(jnp.asarray(packed), K), pcls(torch.from_numpy(packed), K)
        np.testing.assert_array_equal(vol.rho.numpy(), np.asarray(jvol.rho))
        js, s = jvol.init_state(), vol.init_state()
        for _ in range(T + 2):  # rounds past the end repeat the last row
            jx, js = jvol.sample(jax.random.PRNGKey(0), js)
            x, s = vol.sample((), s)
            np.testing.assert_array_equal(x.numpy(), np.asarray(jx))


@pytest.mark.parametrize("kind", ["bits", "lags"])
def test_trace_files_cross_between_packages(tmp_path, kind):
    rng = np.random.default_rng(8)
    packed = (J.pack_trace((rng.random((T, K)) < 0.5).astype(np.float32)) if kind == "bits"
              else J.pack_lags(rng.choice([0, 1, 2, -1], (T, K)).astype(np.int32)))
    a = P.save_packed_trace(str(tmp_path / "port"), packed, K, kind=kind)
    b = J.save_packed_trace(str(tmp_path / "jax"), packed, K, kind=kind)
    for path in (a, b):
        for load in (P.load_packed_trace, J.load_packed_trace):
            arr, meta = load(path)
            np.testing.assert_array_equal(np.asarray(arr), packed)
            assert meta == {"kind": kind, "K": K, "T": T, "clients_per_byte": 8 if kind == "bits" else 4}
    assert open(a, "rb").read() == open(b, "rb").read()
    assert open(a[:-4] + ".meta.json").read() == open(b[:-4] + ".meta.json").read()
    with pytest.raises(ValueError, match="must be"):
        P.save_packed_trace(str(tmp_path / "bad"), packed[:, :-1], K, kind=kind)


@pytest.mark.parametrize("kind", ["bits", "lags"])
def test_streamed_replay_equals_one_shot_and_jax(tmp_path, kind):
    """A chunked stream (chunks of 8 and a tail of 6) equals one chunk, taps
    included; UCB's stream equals JAX's, whose rounds depend only on the
    trace."""
    rng = np.random.default_rng(9)
    packed = (J.pack_trace((rng.random((T, K)) < 0.5).astype(np.float32)) if kind == "bits"
              else J.pack_lags(rng.choice([0, 1, 2, -1], (T, K)).astype(np.int32)))
    path = P.save_packed_trace(str(tmp_path / "trace"), packed, K, kind=kind)
    chunked = P.replay_packed_stream("e3cs", path, 16, chunk=8, frac=0.5, seed=2, taps=True, device="cpu")
    one = P.replay_packed_stream("e3cs", path, 16, chunk=T, frac=0.5, seed=2, taps=True, device="cpu")
    for key in chunked:
        if key == "taps":
            for part in ("series", "counters"):
                for n, v in chunked["taps"][part].items():
                    np.testing.assert_array_equal(v, one["taps"][part][n])
        else:
            np.testing.assert_array_equal(chunked[key], one[key])
    got = P.replay_packed_stream("ucb", path, 16, chunk=8, device="cpu")
    want = J.replay_packed_stream("ucb", path, 16, chunk=8)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    fed = P.replay_packed_stream("fedcs", path, 16, chunk=8, device="cpu")
    np.testing.assert_array_equal(fed["rho"], J.replay_packed_stream("fedcs", path, 16, chunk=8)["rho"])


def test_format_grid_equals_jax():
    rng = np.random.default_rng(10)
    rows = []
    for sc in ("paper_iid", "diurnal"):
        for sel in ("e3cs", "fedcs"):
            row = {"selector": sel, "scenario": sc, "K": 64, "k": 8, "T": 10, "cep": float(rng.integers(0, 80)),
                   "eff_participation": rng.random(), "jain": rng.random(), "entropy": rng.random(),
                   "gini": rng.random(), "top_decile_share": rng.random()}
            if sc == "diurnal":
                row.update(async_cep=90.0, async_eff=rng.random())
            if sel == "e3cs" and sc == "diurnal":
                row.update(async_jain=0.5, lc_cep=91.0, lc_eff=0.6, lc_jain=0.55, lc_drift=1.5e-3)
            rows.append(row)
    for part in (rows[:1], rows[:3], rows):
        assert P.format_grid(part) == J.format_grid(part)


def test_run_grid_multi_job_rows_match_jax_and_do_not_depend_on_the_batch():
    """The seven registry scenarios as the jobs of one batched engine: the
    rows have JAX's keys and deterministic fields; each job's selection and
    model streams are its own (``SeedSequence([seed, j])``), so the first
    scenario's row is the same alone or beside six others."""
    names = ["paper_iid", "markov", "markov_sticky", "deadline", "diurnal", "regional_outage", "flash_crowd"]
    kw = dict(K=256, k=8, T=12, seed=2)
    rows, jrows = P.run_grid_multi_job(names, **kw, device="cpu"), J.run_grid_multi_job(names, **kw)
    assert len(rows) == len(jrows) == 7
    for row, jrow, name in zip(rows, jrows, names):
        assert list(row) == list(jrow)
        assert (row["selector"], row["scenario"], row["K"], row["k"], row["T"]) == (
            "e3cs(multi_job)", name, 256, 8, 12)
        assert 0 <= row["cep"] <= 12 * 8 and row["eff_participation"] == row["cep"] / (12 * 8)
        assert 0 < row["jain"] <= 1 and 0 < row["entropy"] <= 1
    assert P.run_grid_multi_job(names[:1], **kw, device="cpu") == rows[:1]

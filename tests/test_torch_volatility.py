"""The port's volatility models against the JAX package's, given JAX's draws.

Each model's ``sample`` takes the uniform rows JAX's own ``sample`` draws
from its key (``jax.random.split`` in the model's order, then
``jax.random.uniform``), so outcomes compare exactly.  Markov and the lag
views use no transcendental function: bits, lags and the carried P(up) row
are equal exactly.  The deadline model takes ``-log1p(-u)`` of its time row,
and XLA's ``log1p`` may round differently from PyTorch's by an ulp: its bits
are held exactly wherever the client's time is not within ``BAND`` (relative)
of the deadline, and the test counts the draws inside that band.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import volatility as jv
from repro.fl.server import build_volatility as jbuild_volatility
from repro_torch.configs import FLConfig
from repro_torch.core import volatility as tv
from repro_torch.fl.server import build_volatility

K, T = 4096, 30
BAND = 1e-6  # relative distance of a deadline time from the deadline below which a one-ulp log1p may flip the bit


def _t(a):
    return torch.from_numpy(np.array(a))


def _rho():
    return tv.paper_success_rates(K)


def _uniforms(key, n):
    """The ``n`` uniform rows a JAX model's ``sample`` draws from ``key``:
    its ``split`` of the key, in order (a Bernoulli model, ``n = 1``, draws
    from the key itself)."""
    keys = [key] if n == 1 else jax.random.split(key, n)
    return tuple(jax.random.uniform(r, (K,), jnp.float32) for r in keys)


@pytest.mark.parametrize("rho_kind", ["paper", "uniform"])
def test_calibrate_deadline_is_the_jax_solution(rho_kind):
    rng = np.random.default_rng(1)
    rho = _rho() if rho_kind == "paper" else rng.uniform(0.01, 0.99, K).astype(np.float32)
    epochs = rng.choice((1, 2, 3, 4), K).astype(np.float32)
    for got, want in zip(tv.calibrate_deadline(rho, epochs, 3.0, 0.25), jv.calibrate_deadline(rho, epochs, 3.0, 0.25)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,choices", [(0, (1, 2, 3, 4)), (7, (1, 3)), (123, (2, 5, 8))])
def test_make_volatility_draws_the_jax_epochs(seed, choices):
    vol = tv.make_volatility("deadline", _rho(), seed=seed, epochs_choices=choices, device="cpu")
    jvol = jv.make_volatility("deadline", _rho(), seed=seed, epochs_choices=choices)
    for name in ("epochs", "base_time", "p_net_fail"):
        np.testing.assert_array_equal(getattr(vol, name).numpy(), np.asarray(getattr(jvol, name)))
    assert vol.deadline == jvol.deadline and vol.jitter == jvol.jitter


@pytest.mark.parametrize("stickiness", [0.8, 0.95])
def test_markov_equals_jax_round_for_round(stickiness):
    """Markov's ``r_up`` row is the first of its key's split; the second
    (``r_flip``) is never used, so the model takes one row."""
    jvol = jv.MarkovVolatility(jnp.asarray(_rho()), stickiness)
    vol = tv.make_volatility("markov", _rho(), stickiness=stickiness, device="cpu")
    assert len(vol.draw_rows()) == 1
    js, s = jvol.init_state(), vol.init_state()
    key = jax.random.PRNGKey(5)
    for _ in range(T):
        key, sub = jax.random.split(key)
        jx, js = jvol.sample(sub, js)
        x, s = vol.sample((_t(_uniforms(sub, 2)[0]),), s)
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("seed", [0, 3])
def test_deadline_equals_jax_outside_the_band(seed):
    jvol = jv.make_volatility("deadline", _rho(), seed=seed)
    vol = tv.make_volatility("deadline", _rho(), seed=seed, device="cpu")
    key = jax.random.PRNGKey(seed + 10)
    in_band = 0
    for _ in range(T):
        key, sub = jax.random.split(key)
        jx, _ = jvol.sample(sub, jvol.init_state())
        us = _uniforms(sub, 2)
        x, _ = vol.sample(tuple(_t(u) for u in us), vol.init_state())
        t_i = np.asarray(jvol.epochs * jvol.base_time * (1.0 + jax.random.exponential(jax.random.split(sub)[0], (K,))
                                                         * jvol.jitter))
        far = np.abs(t_i - jvol.deadline) > BAND * jvol.deadline
        in_band += int((~far).sum())
        np.testing.assert_array_equal(x.numpy()[far], np.asarray(jx)[far])
    # seeds 0 and 3 put none of their T * K = 122,880 draws in the band; a
    # handful would be within what one-ulp log1p differences can flip
    assert in_band <= 10, in_band


@pytest.mark.parametrize("base", ["bernoulli", "markov", "deadline"])
def test_binary_lag_and_on_time_bits_equal_jax(base):
    """``BinaryLag`` over each builtin model and ``OnTimeBits`` over a
    ``CompletionLag`` of it consume the wrapped model's rows: equal lags and
    bits."""
    jbase = jv.make_volatility(base, _rho(), seed=2)
    tbase = tv.make_volatility(base, _rho(), seed=2, device="cpu")
    n_base = len(tbase.draw_rows())
    key = jax.random.PRNGKey(9)
    jlag, _ = jv.BinaryLag(jbase).sample(key, jbase.init_state())
    us = _uniforms(key, 1 if base == "bernoulli" else 2)[:n_base]
    lag, _ = tv.BinaryLag(tbase).sample(tuple(_t(u) for u in us), tbase.init_state())
    assert lag.dtype == torch.int32
    # Deadline's draws here (key 9, seed 2) put no time within BAND of the deadline: exact
    np.testing.assert_array_equal(lag.numpy(), np.asarray(jlag))
    jcl = jv.CompletionLag(jbase, max_lag=2)
    cl = tv.CompletionLag(tbase, max_lag=2)
    r_base, r_late, r_lag = jax.random.split(key, 3)
    rows = _uniforms(r_base, 1 if base == "bernoulli" else 2)[:n_base] + (
        jax.random.uniform(r_late, (K,), jnp.float32),
        jax.random.uniform(r_lag, (K,), jnp.float32, minval=1e-7, maxval=1.0),
    )
    jx, _ = jcl.on_time_model().sample(key, jcl.init_state())
    x, _ = cl.on_time_model().sample(tuple(_t(u) for u in rows), cl.init_state())
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))


@pytest.mark.parametrize("name,n_rows", [("bernoulli", 1), ("markov", 1), ("deadline", 2)])
def test_models_draw_their_rows(name, n_rows):
    vol = tv.make_volatility(name, _rho(), device="cpu")
    us = vol.draw(torch.Generator().manual_seed(0))
    assert len(us) == n_rows and all(u.shape == (K,) and u.dtype == torch.float32 for u in us)
    x, _ = vol.sample(us, vol.init_state())
    assert set(np.unique(x.numpy())) <= {0.0, 1.0}
    assert abs(float(x.mean()) - float(_rho().mean())) < 0.03


def test_unknown_volatility_model_raises():
    with pytest.raises(ValueError, match="unknown volatility model"):
        tv.make_volatility("weibull", _rho(), device="cpu")


@pytest.mark.parametrize("name", ["markov", "deadline"])
def test_build_volatility_passes_the_config(name):
    """``build_volatility`` hands the config's stickiness, seed and local
    epochs to the model, as the JAX package does."""
    kw = dict(K=K, volatility=name, markov_stickiness=0.9, seed=11, local_epochs=(2, 3))
    vol, rho = build_volatility(FLConfig(**kw), K, device="cpu")
    from repro.configs import FLConfig as JFLConfig

    jvol, jrho = jbuild_volatility(JFLConfig(**kw), K)
    np.testing.assert_array_equal(rho.numpy(), np.asarray(jrho))
    if name == "markov":
        assert vol.stickiness == jvol.stickiness == 0.9
    else:
        np.testing.assert_array_equal(vol.epochs.numpy(), np.asarray(jvol.epochs))
        np.testing.assert_array_equal(vol.base_time.numpy(), np.asarray(jvol.base_time))


def test_build_volatility_takes_a_models_marginal_rate():
    """A model object with no ``rho`` hands over its ``marginal_rate()``."""

    class NoRho:
        def marginal_rate(self):
            return np.full(8, 0.25, np.float32)

    _, rho = build_volatility(FLConfig(K=8), 8, volatility=NoRho(), device="cpu")
    np.testing.assert_array_equal(rho.numpy(), np.full(8, 0.25, np.float32))

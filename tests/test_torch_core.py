"""The port's core selection math against the JAX package's, on the same
inputs made with numpy from a seed: the sorted allocator, the sort-free
bisection allocator and its scalars, the E3CS update, the quota schedules,
and the volatility models fed JAX's own uniform draws.

Outcomes of the volatility models are integers and must be equal exactly.
Allocations and weights are float32 results of sums taken in another order
(XLA's and PyTorch's reductions, the sorted allocator's cumulative sum), so
they are held to ``RTOL``/``ATOL`` (a few ulps); the allocation's overflow
set ``capped`` must be equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.selection import e3cs_update as je3cs_update
from repro.core.selection import make_quota_schedule as jmake_quota_schedule
from repro.core.selection import prob_alloc as jprob_alloc
from repro.core.selection.e3cs import E3CSState as JE3CSState
from repro.core.volatility import CompletionLag as JCompletionLag
from repro.core.volatility import make_volatility as jmake_volatility
from repro.core.volatility import paper_success_rates as jpaper_success_rates
from repro.engine.sharded import masked_prob_alloc as jmasked_prob_alloc
from repro.engine.sharded import masked_prob_alloc_scalars as jmasked_prob_alloc_scalars
from repro_torch.core.selection import E3CSState, e3cs_update, make_quota_schedule, prob_alloc
from repro_torch.core.volatility import CompletionLag, make_volatility, paper_success_rates
from repro_torch.engine.sharded import masked_prob_alloc, masked_prob_alloc_scalars

RTOL, ATOL = 2e-6, 1e-7  # float32: a few ulps from reductions taken in another order


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(K, seed, spread):
    """Exponential weights whose log spread makes the allocation overflow
    (``spread`` large) or not (small)."""
    logw = np.random.default_rng(seed).normal(0, spread, K).astype(np.float32)
    return np.exp(logw - logw.max()).astype(np.float32)


ALLOC_CASES = [(K, k, frac, spread) for K, k in ((100, 20), (1000, 50), (4099, 7))
               for frac in (0.0, 0.9) for spread in (0.1, 3.0)]


@pytest.mark.parametrize("K,k,frac,spread", ALLOC_CASES)
def test_prob_alloc_matches_jax(K, k, frac, spread):
    w = _weights(K, K + k, spread)
    sigma = np.float32(frac * k / K)
    jp, jc = jprob_alloc(jnp.asarray(w), k, jnp.float32(sigma))
    p, c = prob_alloc(_t(w), k, _t(sigma))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_active", [False, True], ids=["dense", "active"])
@pytest.mark.parametrize("K,k,frac,spread", ALLOC_CASES)
def test_masked_prob_alloc_matches_jax(K, k, frac, spread, with_active):
    w = _weights(K, K * 7 + k, spread)
    sigma = np.float32(frac * k / K)
    active = (np.random.default_rng(K).random(K) < 0.9).astype(np.float32) if with_active else None
    ja = None if active is None else jnp.asarray(active)
    ta = None if active is None else _t(active)
    jp, jc = jmasked_prob_alloc(jnp.asarray(w), k, jnp.float32(sigma), active=ja)
    p, c = masked_prob_alloc(_t(w), k, _t(sigma), active=ta)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=RTOL, atol=ATOL)
    jsc = jmasked_prob_alloc_scalars(jnp.asarray(w), k, jnp.float32(sigma), active=ja)
    sc = masked_prob_alloc_scalars(_t(w), k, _t(sigma), active=ta)
    assert bool(sc[3]) == bool(jsc[3])  # use_cap: the overflow branch taken
    for name, a, b in zip(("residual", "cap", "denom"), sc[:3], jsc[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, err_msg=name)


def test_block_mode_is_not_ported():
    """Block mode was the unported part of the allocator; it is ported now
    (``test_torch_sharded.py`` holds it against JAX): it matches JAX's block
    mode on a small population, and a block below 1 raises."""
    w, sigma = _weights(64, 0, 1.0), np.float32(0.05)
    jp, jc = jmasked_prob_alloc(jnp.asarray(w), 8, jnp.float32(sigma), block=4)
    p, c = masked_prob_alloc(_t(w), 8, _t(sigma), block=4)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="block"):
        masked_prob_alloc(_t(w), 8, _t(sigma), block=0)


@pytest.mark.parametrize("with_active", [False, True], ids=["dense", "active"])
@pytest.mark.parametrize("K,k,frac", [(100, 20, 0.5), (1000, 50, 0.0), (4099, 7, 0.9)])
def test_e3cs_update_matches_jax(K, k, frac, with_active):
    rng = np.random.default_rng(K)
    logw = rng.normal(0, 1, K).astype(np.float32)
    p = np.clip(rng.gamma(1.0, 1.0, K) / K * k, 1e-4, 1.0).astype(np.float32)
    capped = rng.random(K) < 0.05
    mask = np.zeros(K, np.float32)
    mask[rng.choice(K, k, replace=False)] = 1.0
    x = (rng.random(K) < 0.6).astype(np.float32)
    sigma = np.float32(frac * k / K)
    active = (rng.random(K) < 0.9).astype(np.float32) if with_active else None
    js = je3cs_update(JE3CSState(jnp.asarray(logw), jnp.int32(4)), jnp.asarray(p), jnp.asarray(capped),
                      jnp.asarray(mask), jnp.asarray(x), k, jnp.float32(sigma), 0.5,
                      active=None if active is None else jnp.asarray(active))
    s = e3cs_update(E3CSState(_t(logw), torch.tensor(4, dtype=torch.int32)), _t(p), _t(capped), _t(mask), _t(x),
                    k, _t(sigma), 0.5, active=None if active is None else _t(active))
    np.testing.assert_allclose(s.logw.numpy(), np.asarray(js.logw), rtol=RTOL, atol=ATOL)
    assert int(s.t) == int(js.t) == 5


@pytest.mark.parametrize("name", ["const", "inc", "linear", "cosine"])
def test_quota_schedules_match_jax(name):
    K, k, T = 1000, 50, 40
    jf = jmake_quota_schedule(name, k, K, T, 0.5)
    f = make_quota_schedule(name, k, K, T, 0.5)
    for t in range(T + 2):
        got = f(torch.tensor(t, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.numpy(), np.asarray(jf(jnp.int32(t))), rtol=1e-6, err_msg=f"t={t}")


def test_unknown_quota_schedule_raises():
    with pytest.raises(ValueError, match="quota"):
        make_quota_schedule("exp", 5, 50, 10)


@pytest.mark.parametrize("K", [7, 100, 1001])
@pytest.mark.parametrize("remainder", ["stable", "spread"])
def test_paper_success_rates_match_jax(K, remainder):
    np.testing.assert_array_equal(paper_success_rates(K, remainder=remainder),
                                  jpaper_success_rates(K, remainder=remainder))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bernoulli_matches_jax_given_its_uniforms(seed):
    K = 1001
    rho = paper_success_rates(K)
    key = jax.random.PRNGKey(seed)
    jx, _ = jmake_volatility("bernoulli", rho).sample(key, None)
    u = jax.random.uniform(key, (K,), jnp.float32)  # bernoulli's own draw
    vol = make_volatility("bernoulli", rho)
    x, _ = vol.sample((_t(u),), vol.init_state())
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))


@pytest.mark.parametrize("max_lag,p_late,lag_decay", [(2, 0.7, 0.5), (4, 0.9, 0.3), (1, 0.5, 0.5)])
def test_completion_lag_matches_jax_given_its_uniforms(max_lag, p_late, lag_decay):
    K = 1001
    rho = paper_success_rates(K)
    key = jax.random.PRNGKey(max_lag)
    jvol = JCompletionLag(jmake_volatility("bernoulli", rho), p_late=p_late, lag_decay=lag_decay, max_lag=max_lag)
    jlag, _ = jvol.sample(key, jvol.init_state())
    r_base, r_late, r_lag = jax.random.split(key, 3)  # CompletionLag.sample's own split
    us = (
        jax.random.uniform(r_base, (K,), jnp.float32),
        jax.random.uniform(r_late, (K,), jnp.float32),
        jax.random.uniform(r_lag, (K,), jnp.float32, minval=1e-7, maxval=1.0),
    )
    vol = CompletionLag(make_volatility("bernoulli", rho), p_late=p_late, lag_decay=lag_decay, max_lag=max_lag)
    lag, _ = vol.sample(tuple(_t(u) for u in us), vol.init_state())
    assert lag.dtype == torch.int32
    np.testing.assert_array_equal(lag.numpy(), np.asarray(jlag))


def test_completion_lag_draws_its_rows_in_range():
    vol = CompletionLag(make_volatility("bernoulli", paper_success_rates(4096)), max_lag=3)
    us = vol.draw(torch.Generator().manual_seed(0))
    assert len(us) == 3 and all(u.shape == (4096,) and u.dtype == torch.float32 for u in us)
    assert float(us[2].min()) >= 1e-7 and float(us[2].max()) < 1.0
    lag, _ = vol.sample(us, vol.init_state())
    assert set(np.unique(lag.numpy())) <= {-1, 0, 1, 2, 3}


@pytest.mark.parametrize("name", ["markov", "deadline"])
def test_unported_volatility_models_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_volatility(name, paper_success_rates(8))

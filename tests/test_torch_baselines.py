"""The baselines, the systematic sampler and every scheme's round against the
JAX package, given JAX's draws.

Selectors: each takes the noise JAX's own selector draws from its key (a
permutation, a uniform row, or a permutation and a 0-d uniform), so the
cohorts must be equal exactly, ties included: FedCS over the paper's four
rates (``1e-6 * u`` leaves ties of equal float32 scores) and UCB's first
rounds (every unexplored client scores ``+inf``) resolve to the lowest
index, as ``lax.top_k`` does.  On the CPU the client-wide top-k is the
plain version of the top-k kernel's wrapper; the card runs the kernel
(``chip_smoke.py``).

Rounds: the JAX ``RoundProgram`` runs a whole horizon of each scheme (sync
and async S = 2, outcomes from a dense trace or from a Bernoulli model);
the test replays JAX's key discipline (``split(key, 3)`` a round, ``k1`` to
selection, ``k2`` to the model) to take each round's noise and feeds it to
the port's round step.  Masks, lags, counts and the UCB state must be equal
exactly; ``p`` and ``logw`` of E3CS within ``RTOL``/``ATOL`` (sums in another
order, as in ``test_torch_round_program.py``); the baselines' ``p`` (their
cohort mask, or ``k/K``) exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFLConfig
from repro.core.selection import baselines as jb
from repro.core.selection import sampling as js
from repro.core.volatility import CompletionLag as JCompletionLag
from repro.core.volatility import make_volatility as jmake_volatility
from repro.engine.round_program import RoundProgram as JRoundProgram
from repro_torch.configs import FLConfig
from repro_torch.core.selection import baselines as tb
from repro_torch.core.selection import sampling as ts
from repro_torch.core.volatility import CompletionLag, make_volatility, paper_success_rates
from repro_torch.engine import RoundNoise, RoundProgram

K, k, T, SEED = 256, 16, 20, 4
RTOL, ATOL = 1e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the selectors -------------------------------------------------------------


@pytest.mark.parametrize("n,kk", [(256, 16), (4096, 64)])
def test_random_select_equals_jax(n, kk):
    key = jax.random.PRNGKey(n)
    perm = _t(jax.random.permutation(key, n)).long()
    np.testing.assert_array_equal(tb.random_select(perm, n, kk).numpy(), np.asarray(jb.random_select(key, n, kk)))


@pytest.mark.parametrize("noise", [True, False], ids=["uniform", "no_noise"])
@pytest.mark.parametrize("n,kk", [(256, 16), (4096, 64)])
def test_fedcs_select_keeps_jax_tie_order(n, kk, noise):
    """The paper's rates are four values: with ``1e-6 * u`` added, equal
    float32 scores remain; without it every class is one tie."""
    rho = paper_success_rates(n)
    key = jax.random.PRNGKey(n + 1)
    want = np.asarray(jb.fedcs_select(jnp.asarray(rho), kk, key if noise else None))
    u = _t(jax.random.uniform(key, (n,))) if noise else None
    got = tb.fedcs_select(torch.from_numpy(rho), kk, u).numpy()
    np.testing.assert_array_equal(got, want)
    if noise:  # the tie the issue names: equal scores among the selected class
        score = rho + np.float32(1e-6) * np.asarray(jax.random.uniform(key, (n,)))
        assert len(np.unique(score[want])) < kk


@pytest.mark.parametrize("loss_kind", ["unexplored", "random", "ties"])
def test_pow_d_select_equals_jax(loss_kind):
    rng = np.random.default_rng(2)
    loss = {"unexplored": np.full(K, 1e9), "random": rng.random(K),
            "ties": rng.integers(0, 3, K).astype(np.float64)}[loss_kind].astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jb.pow_d_select(key, jnp.asarray(loss), k, 40))
    got = tb.pow_d_select(_t(jax.random.permutation(key, K)).long(), torch.from_numpy(loss), k, 40)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="k <= d"):
        tb.pow_d_select(torch.arange(K), torch.from_numpy(loss), 41, 40)


def test_ucb_select_and_update_equal_jax_with_inf_ties():
    """From the initial state every client scores ``+inf``: the first rounds
    take the lowest unexplored indices, as ``lax.top_k`` does."""
    n = 4096
    rng = np.random.default_rng(3)
    jstate, state = jb.ucb_init(n), tb.ucb_init(n, device="cpu")
    for t in range(12):
        jidx, idx = jb.ucb_select(jstate, 64), tb.ucb_select(state, 64)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        if t == 0:
            np.testing.assert_array_equal(idx.numpy(), np.arange(64))
        x = (rng.random(n) < 0.5).astype(np.float32)
        jstate, state = jb.ucb_update(jstate, jidx, jnp.asarray(x)), tb.ucb_update(state, idx, torch.from_numpy(x))
        for a, b in zip(state, jstate):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _probs(n, kk, seed):
    """An allocation with ``sum(p) = kk`` and ``p <= 1`` (some clients capped)."""
    w = np.random.default_rng(seed).gamma(0.5, 1.0, n)
    p = np.minimum(w / w.sum() * kk, 1.0)
    for _ in range(50):
        free = p < 1.0
        p[free] *= (kk - (~free).sum()) / p[free].sum()
        p = np.minimum(p, 1.0)
    return p.astype(np.float32)


@pytest.mark.parametrize("n,kk", [(256, 16), (1024, 40), (4096, 64)])
def test_systematic_sample_equals_jax(n, kk):
    """Parity at K <= 4096: the hit test reads a float32 cumulative sum,
    which both frameworks add in order at these sizes."""
    p = _probs(n, kk, n)
    for s in range(5):
        key = jax.random.PRNGKey(s)
        want = np.asarray(js.systematic_sample(key, jnp.asarray(p), kk))
        r_perm, r_u = jax.random.split(key)
        perm = _t(jax.random.permutation(r_perm, n)).long()
        u = _t(jax.random.uniform(r_u, (), jnp.float32))
        got = ts.systematic_sample(perm, u, torch.from_numpy(p), kk).numpy()
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got)) == kk


@pytest.mark.parametrize("method", ["plackett_luce", "systematic"])
def test_inclusion_probabilities_follow_p(method):
    """Systematic sampling includes client i with probability exactly p_i;
    Plackett-Luce only approximately.  Monte Carlo over 400 draws."""
    p = _probs(64, 8, 0)
    est = ts.inclusion_probability_mc(torch.Generator().manual_seed(0), torch.from_numpy(p), 8, 400, method)
    assert abs(float(est.sum()) - 8.0) < 1e-4
    if method == "systematic":
        # 5 binomial standard deviations of a 400-draw mean
        assert np.all(np.abs(est.numpy() - p) <= 5 * np.sqrt(p * (1 - p) / 400) + 1e-6)


def test_sample_selection_rejects_an_unknown_method():
    with pytest.raises(ValueError, match="unknown sampling method"):
        ts.sample_selection(RoundNoise(), torch.ones(4), 2, "reservoir")


# -- every scheme, round for round ----------------------------------------------

SCHEMES = [("e3cs", "plackett_luce"), ("e3cs", "systematic"), ("random", "plackett_luce"),
           ("fedcs", "plackett_luce"), ("pow_d", "plackett_luce"), ("ucb", "plackett_luce")]


def _trace(staleness):
    rng = np.random.default_rng(13)
    if staleness is None:
        return rng.binomial(1, 0.6, (T, K)).astype(np.float32)
    return rng.choice([0, 1, 2, -1], size=(T, K), p=[0.5, 0.15, 0.1, 0.25]).astype(np.int32)


def _programs(scheme, sampler, staleness, override):
    kw = dict(K=K, k=k, rounds=T, scheme=scheme, sampler=sampler, quota_frac=0.5, allocator="sort")
    rho = paper_success_rates(K)
    jvol, vol = jmake_volatility("bernoulli", rho), make_volatility("bernoulli", rho, device="cpu")
    if staleness is not None:
        jvol, vol = JCompletionLag(jvol, max_lag=staleness), CompletionLag(vol, max_lag=staleness)
    common = dict(rho=rho, override=override, staleness=staleness, alpha=0.5)
    return (JRoundProgram(fl=JFLConfig(**kw), vol=jvol, **common),
            RoundProgram(fl=FLConfig(**kw), vol=vol, device="cpu", **common))


def _jax_noise(scheme, sampler, staleness, override):
    """Each round's noise as JAX draws it: the selection's from ``k1``, the
    model's from ``k2`` (``CompletionLag`` splits ``k2`` in three)."""
    key = jax.random.PRNGKey(SEED)
    rounds = []
    for _ in range(T):
        key, k1, k2 = jax.random.split(key, 3)
        sel = {}
        if scheme == "e3cs" and sampler == "plackett_luce":
            sel["g"] = _t(jax.random.gumbel(k1, (K,), jnp.float32))
        elif scheme == "e3cs":
            r_perm, r_u = jax.random.split(k1)
            sel["perm"] = _t(jax.random.permutation(r_perm, K)).long()
            sel["v"] = _t(jax.random.uniform(r_u, (), jnp.float32))
        elif scheme in ("random", "pow_d"):
            sel["perm"] = _t(jax.random.permutation(k1, K)).long()
        elif scheme == "fedcs":
            sel["v"] = _t(jax.random.uniform(k1, (K,), jnp.float32))
        u = ()
        if override == "none":
            if staleness is None:
                u = (_t(jax.random.uniform(k2, (K,), jnp.float32)),)
            else:
                r_base, r_late, r_lag = jax.random.split(k2, 3)
                u = tuple(_t(jax.random.uniform(r, (K,), jnp.float32)) for r in (r_base, r_late)) + (
                    _t(jax.random.uniform(r_lag, (K,), jnp.float32, minval=1e-7, maxval=1.0)),)
        rounds.append(RoundNoise(u=u, **sel))
    return rounds


@functools.lru_cache(maxsize=None)
def _jax_run(scheme, sampler, staleness, override):
    jpm, _ = _programs(scheme, sampler, staleness, override)
    run, s0 = jpm.build_runner(outputs="full")
    xs = jnp.asarray(_trace(staleness)) if override == "dense" else jnp.zeros((T, 0), jnp.float32)
    st, *outs = run(s0, jax.random.PRNGKey(SEED), xs)
    return st, [np.asarray(o) for o in outs]


@pytest.mark.parametrize("override", ["dense", "none"])
@pytest.mark.parametrize("staleness", [None, 2], ids=["sync", "async"])
@pytest.mark.parametrize("scheme,sampler", SCHEMES)
def test_every_scheme_equals_jax_round_for_round(scheme, sampler, staleness, override):
    jstate, jouts = _jax_run(scheme, sampler, staleness, override)
    _, pm = _programs(scheme, sampler, staleness, override)
    step, state = pm.build_step()
    carry = (state,) if staleness is None else (state, pm.init_rings())
    trace = _trace(staleness)
    outs = []
    for t, noise in enumerate(_jax_noise(scheme, sampler, staleness, override)):
        carry, out = step(carry, torch.from_numpy(trace[t]) if override == "dense" else None, noise)
        outs.append(out)
    outs = [torch.stack(c).numpy() for c in zip(*outs)]
    exact = [0, 1] + ([4] if staleness is not None else [])  # masks, x or lags, arrived
    for i in exact:
        np.testing.assert_array_equal(outs[i], jouts[i])
    assert np.all(outs[0].sum(1) == k)
    if scheme == "e3cs":
        np.testing.assert_allclose(outs[2], jouts[2], rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(outs[2], jouts[2])
    state = carry[0]
    np.testing.assert_array_equal(state.sel_counts.numpy(), np.asarray(jstate.sel_counts))
    np.testing.assert_array_equal(state.loss_cache.numpy(), np.asarray(jstate.loss_cache))
    for a, b in zip(state.ucb, jstate.ucb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(state.e3cs.logw.numpy(), np.asarray(jstate.e3cs.logw), rtol=RTOL, atol=ATOL)
    if staleness is not None:
        np.testing.assert_allclose(float(state.cep), float(jstate.cep), rtol=1e-6)


@pytest.mark.parametrize("scheme,sampler", SCHEMES[1:])
def test_every_scheme_runs_its_captured_horizon_as_the_step_loop(scheme, sampler):
    """The runner draws each scheme's noise (permutations included) into its
    static buffers: its horizon equals a hand loop of ``build_step`` +
    ``draw_noise`` from the same generator bit for bit, generator state
    included."""
    _, pm = _programs(scheme, sampler, None, "none")
    run, s0 = pm.build_runner(outputs="full", carry_key=True)
    got = run(s0, SEED)
    step, _ = pm.build_step()
    gen = pm.generator(SEED)
    carry, outs = (s0,), []
    for _ in range(T):
        carry, out = step(carry, None, pm.draw_noise(gen))
        outs.append(out)
    want = (carry[0], gen.get_state(), *(torch.stack(c) for c in zip(*outs)))
    leaves, ref = torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)
    assert len(leaves) == len(ref) and all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(leaves, ref))


def test_late_credit_feedback_leaves_a_baseline_alone():
    """As in JAX, late-credit feedback buffers only E3CS's estimator: a
    baseline's async program carries one ring."""
    _, pm = _programs("random", "plackett_luce", 2, "none")
    pm = RoundProgram(fl=pm.fl, vol=pm.vol, rho=pm.rho, staleness=2, feedback="late_credit", device="cpu")
    assert len(pm.init_rings()) == 1


def test_pow_d_needs_k_candidates():
    with pytest.raises(ValueError, match="k <= d"):
        RoundProgram(fl=FLConfig(K=K, k=50, scheme="pow_d"), vol=make_volatility("bernoulli", paper_success_rates(K), device="cpu"),
                     rho=paper_success_rates(K), device="cpu")

"""The port's round program against the JAX package's, round for round.

The slice as a whole at K=256, k=16, T=20: the JAX ``RoundProgram`` runs its
whole horizon with outcomes replayed from a trace (``override="dense"``,
``"packed"`` or ``"packed_lags"``); the test replays JAX's key discipline
(``split(key, 3)`` each round, ``k1`` to ``jax.random.gumbel``) to take each
round's Gumbel row and feeds those rows, with the same trace rows, to the
port's round step.  The JAX reference runs on the CPU with its plain
reference path (its Pallas kernels are held against the port's plain
versions in ``test_torch_kernels.py``).

Masks, lags and cohorts must be equal exactly.  Floats are held to
``RTOL``/``ATOL``: the two frameworks sum in different orders (the
bisection's tiled sums, the sorted allocator's cumulative sums), so ``p``
may differ in its last bits, and those bits reach ``logw`` through the
importance weight ``1/p`` each round.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFLConfig
from repro.core.volatility import CompletionLag as JCompletionLag
from repro.core.volatility import make_volatility as jmake_volatility
from repro.engine.round_program import RoundProgram as JRoundProgram
from repro.scenarios.replay import pack_lags, pack_trace
from repro_torch.configs import FLConfig
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.core.volatility import CompletionLag, make_volatility, paper_success_rates
from repro_torch.engine import RoundNoise, RoundProgram

K, k, T, SEED, FRAC = 256, 16, 20, 3, 0.5
RTOL, ATOL = 1e-5, 1e-5  # float32 sums in another order: a few ulps in p, carried into logw


def _rho():
    return paper_success_rates(K)


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_gumbel_rows(key, n):
    """JAX's per-round selection noise: the ``k1`` Gumbel row of each round."""

    def body(key, _):
        key, k1, _ = jax.random.split(key, 3)
        return key, jax.random.gumbel(k1, (K,), jnp.float32)

    return jax.lax.scan(body, key, None, length=n)


def _trace(override):
    rng = np.random.default_rng(11)
    if override == "dense_async" or override == "packed_lags":
        lags = rng.choice([0, 1, 2, -1], size=(T, K), p=[0.5, 0.15, 0.1, 0.25]).astype(np.int32)
        return lags, pack_lags(lags)
    bits = rng.binomial(1, 0.6, (T, K)).astype(np.float32)
    return bits, pack_trace(bits)


def _programs(*, staleness, allocator, feedback, override, fused, quota="const"):
    kw = dict(K=K, k=k, rounds=T, scheme="e3cs", quota=quota, quota_frac=FRAC, allocator=allocator)
    rho = _rho()
    if staleness is None:
        jvol, vol = jmake_volatility("bernoulli", rho), make_volatility("bernoulli", rho, device="cpu")
    else:
        jvol = JCompletionLag(jmake_volatility("bernoulli", rho), max_lag=staleness)
        vol = CompletionLag(make_volatility("bernoulli", rho, device="cpu"), max_lag=staleness)
    common = dict(rho=rho, override=override, staleness=staleness, alpha=0.5, feedback=feedback)
    jpm = JRoundProgram(fl=JFLConfig(**kw), vol=jvol, **common)
    pm = RoundProgram(fl=FLConfig(**kw), vol=vol, fused=fused, device="cpu", **common)
    return jpm, pm


def _port_horizon(pm, carry, rows, gumbel, n):
    step, _ = pm.build_step()
    outs = []
    for t in range(n):
        x_over = torch.from_numpy(np.array(rows[t])) if rows is not None else None
        carry, out = step(carry, x_over, RoundNoise(g=torch.from_numpy(np.array(gumbel[t]))))
        outs.append(out)
    return carry, [torch.stack(c).numpy() for c in zip(*outs)]


def _assert_state(jstate, state, jrings=(), rings=()):
    got = state_to_numpy(state, rings)
    np.testing.assert_array_equal(got["sel_counts"], np.asarray(jstate.sel_counts))
    np.testing.assert_allclose(got["logw"], np.asarray(jstate.e3cs.logw), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["loss_cache"], np.asarray(jstate.loss_cache), rtol=RTOL, atol=ATOL)
    assert got["t"] == int(jstate.t)
    np.testing.assert_allclose(got["cep"], float(jstate.cep), rtol=RTOL)
    for a, b in zip(rings, jrings):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


SYNC_CASES = [(a, o, q) for a in ("sort", "bisect") for o in ("dense", "packed") for q in ("const",)] + [
    ("bisect", "dense", "linear"),
]
ASYNC_CASES = [(a, f, o) for a in ("sort", "bisect") for f in ("deadline", "late_credit") for o in ("dense",)] + [
    ("bisect", "late_credit", "packed_lags"),
    ("sort", "deadline", "packed_lags"),
]


@functools.lru_cache(maxsize=None)
def _jax_sync(allocator, override, quota):
    jpm, _ = _programs(staleness=None, allocator=allocator, feedback="deadline", override=override,
                       fused=False, quota=quota)
    dense, packed = _trace("dense")
    run, s0 = jpm.build_runner(outputs="full")
    st, masks, xs, ps, sigmas = run(s0, jax.random.PRNGKey(SEED), jnp.asarray(dense if override == "dense" else packed))
    return st, np.asarray(masks), np.asarray(xs), np.asarray(ps), np.asarray(sigmas)


@functools.lru_cache(maxsize=None)
def _jax_async(allocator, feedback, override):
    jpm, _ = _programs(staleness=2, allocator=allocator, feedback=feedback, override=override, fused=False)
    lags, packed = _trace("dense_async")
    run, s0 = jpm.build_runner(outputs="full")
    st, masks, lg, ps, sigmas, arrived = run(
        s0, jax.random.PRNGKey(SEED), jnp.asarray(lags if override == "dense" else packed)
    )
    return st, np.asarray(masks), np.asarray(lg), np.asarray(ps), np.asarray(sigmas), np.asarray(arrived)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
@pytest.mark.parametrize("allocator,override,quota", SYNC_CASES)
def test_sync_round_matches_jax(allocator, override, quota, fused):
    jst, jmasks, jxs, jps, jsig = _jax_sync(allocator, override, quota)
    _, pm = _programs(staleness=None, allocator=allocator, feedback="deadline", override=override,
                      fused=fused, quota=quota)
    dense, packed = _trace("dense")
    _, gumbel = _jax_gumbel_rows(jax.random.PRNGKey(SEED), T)
    _, s0 = pm.build_step()
    (st,), (masks, xs, ps, sig) = _port_horizon(pm, (s0,), dense if override == "dense" else packed, gumbel, T)
    np.testing.assert_array_equal(masks, jmasks)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_allclose(ps, jps, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sig, jsig, rtol=1e-6)
    _assert_state(jst, st)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
@pytest.mark.parametrize("allocator,feedback,override", ASYNC_CASES)
def test_async_round_matches_jax(allocator, feedback, override, fused):
    jst, jmasks, jlags, jps, jsig, jarr = _jax_async(allocator, feedback, override)
    _, pm = _programs(staleness=2, allocator=allocator, feedback=feedback, override=override, fused=fused)
    lags, packed = _trace("dense_async")
    _, gumbel = _jax_gumbel_rows(jax.random.PRNGKey(SEED), T)
    _, s0 = pm.build_step()
    (st, rings), (masks, lg, ps, sig, arrived) = _port_horizon(
        pm, (s0, pm.init_rings()), lags if override == "dense" else packed, gumbel, T
    )
    np.testing.assert_array_equal(masks, jmasks)
    np.testing.assert_array_equal(lg, jlags)
    np.testing.assert_allclose(ps, jps, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(arrived, jarr, rtol=RTOL, atol=ATOL)
    _assert_state(jst, st)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_state_from_jax_continues_like_jax(fused):
    """JAX runs 10 rounds; its state and rings cross over and the port runs
    the next 10 with JAX's noise; JAX runs the same 10 from its own state."""
    half = T // 2
    jpm, pm = _programs(staleness=2, allocator="bisect", feedback="late_credit", override="dense", fused=fused)
    lags, _ = _trace("dense_async")
    run, s0 = jpm.build_runner(outputs="full", carry_key=True, scan_length=half)
    js, jkey, jrings, *_ = run(s0, jax.random.PRNGKey(SEED), jpm.init_rings(), jnp.asarray(lags[:half]))
    arrays = {
        "logw": js.e3cs.logw, "t": js.t, "sel_counts": js.sel_counts, "loss_cache": js.loss_cache,
        "vol_state": js.vol_state, "cep": js.cep, "succ_hist": js.succ_hist, "credit": jrings[0], "fb": jrings[1],
    }
    state, rings = state_from_jax({n: np.asarray(v) for n, v in arrays.items()}, device="cpu")
    js2, _, jrings2, jmasks, jlg, *_ = run(js, jkey, jrings, jnp.asarray(lags[half:]))
    _, gumbel = _jax_gumbel_rows(jkey, half)
    (st, rings2), (masks, lg, *_) = _port_horizon(pm, (state, rings), lags[half:], gumbel, half)
    np.testing.assert_array_equal(masks, np.asarray(jmasks))
    np.testing.assert_array_equal(lg, np.asarray(jlg))
    _assert_state(js2, st, jrings2, rings2)


def test_state_round_trips_through_numpy():
    _, pm = _programs(staleness=2, allocator="bisect", feedback="late_credit", override="none", fused=True)
    run, s0 = pm.build_runner(outputs="lean", carry_key=True, scan_length=3)
    st, _, rings, *_ = run(s0, 7, pm.init_rings())
    arrays = state_to_numpy(st, rings)
    back, rings2 = state_from_jax(arrays, device="cpu")
    again = state_to_numpy(back, rings2)
    assert set(again) == set(arrays)
    for name in arrays:
        np.testing.assert_array_equal(again[name], arrays[name], err_msg=name)


@pytest.mark.parametrize("staleness", [None, 2], ids=["sync", "async"])
def test_chunked_carry_key_equals_one_shot(staleness):
    """Two chunks that hand the generator state (and rings) on equal one
    run over the whole horizon, bit for bit."""
    feedback = "deadline" if staleness is None else "late_credit"
    _, pm = _programs(staleness=staleness, allocator="bisect", feedback=feedback, override="none", fused=True)
    one, s0 = pm.build_runner(outputs="full", carry_key=True)
    half, _ = pm.build_runner(outputs="full", carry_key=True, scan_length=T // 2)
    if staleness is None:
        st, _, *outs = one(s0, SEED)
        st1, key, *o1 = half(s0, SEED)
        st2, _, *o2 = half(st1, key)
    else:
        rings0 = pm.init_rings()
        st, _, _, *outs = one(s0, SEED, rings0)
        st1, key, rings, *o1 = half(s0, SEED, rings0)
        st2, _, _, *o2 = half(st1, key, rings)
        assert all(float(r.abs().sum()) == 0.0 for r in rings0), "the runner must not change the caller's rings"
    for a, b1, b2 in zip(outs, o1, o2):
        torch.testing.assert_close(a, torch.cat([b1, b2]), rtol=0, atol=0)
    torch.testing.assert_close(st.e3cs.logw, st2.e3cs.logw, rtol=0, atol=0)
    torch.testing.assert_close(st.sel_counts, st2.sel_counts, rtol=0, atol=0)


def test_fused_and_staged_runners_select_identically():
    """Given the same seed the two branches consume the same Gumbel rows."""
    outs = []
    for fused in (True, False):
        _, pm = _programs(staleness=2, allocator="bisect", feedback="late_credit", override="none", fused=fused)
        run, s0 = pm.build_runner(outputs="full")
        outs.append(run(s0, SEED))
    np.testing.assert_array_equal(outs[0][1].numpy(), outs[1][1].numpy())
    np.testing.assert_array_equal(outs[0][2].numpy(), outs[1][2].numpy())
    torch.testing.assert_close(outs[0][0].e3cs.logw, outs[1][0].e3cs.logw, rtol=RTOL, atol=ATOL)


RUNNER_CASES = [(None, "deadline", "none"), (None, "deadline", "dense"), (2, "deadline", "none"),
                (2, "late_credit", "none"), (2, "late_credit", "packed_lags")]


@pytest.mark.parametrize("carry_key", [False, True], ids=["one_shot", "carry_key"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
@pytest.mark.parametrize("staleness,feedback,override", RUNNER_CASES)
def test_runner_equals_the_eager_step_loop(staleness, feedback, override, fused, carry_key):
    """The runner's static buffers (carry, uniform rows, trace row, packed
    outputs) change nothing: its horizon equals a hand loop of ``build_step``
    + ``draw_noise`` from the same generator bit for bit, the generator's
    state included, at its first call and again."""
    _, pm = _programs(staleness=staleness, allocator="bisect", feedback=feedback, override=override, fused=fused)
    dense, packed = _trace("dense_async" if staleness else "dense")
    xs = None if override == "none" else torch.from_numpy(dense if override == "dense" else packed)
    run, s0 = pm.build_runner(outputs="full", carry_key=carry_key)
    rings = () if staleness is None or not carry_key else (pm.init_rings(),)
    got = [run(s0, SEED, *rings, xs) for _ in range(2)]
    step, _ = pm.build_step()
    gen = pm.generator(SEED)
    carry = (s0,) if staleness is None else (s0, pm.init_rings())
    outs = []
    for t in range(T):
        carry, out = step(carry, None if xs is None else xs[t], pm.draw_noise(gen))
        outs.append(out)
    stacked = [torch.stack(c) for c in zip(*outs)]
    want = (carry[0], gen.get_state(), *carry[1:], *stacked) if carry_key else (carry[0], *stacked)
    for result in got:
        leaves, ref = torch.utils._pytree.tree_leaves(result), torch.utils._pytree.tree_leaves(want)
        assert len(leaves) == len(ref)
        for a, b in zip(leaves, ref):
            assert (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b))


def test_draw_noise_is_the_raw_rows_transformed():
    """``draw_noise`` = ``noise_from_uniforms`` of ``draw_uniforms``, and the
    rows drawn into buffers are the rows ``torch.rand`` returns."""
    _, pm = _programs(staleness=2, allocator="bisect", feedback="deadline", override="none", fused=True)
    a, b = pm.generator(1), pm.generator(1)
    bufs = [torch.empty(K) for _ in range(4)]
    raw = pm.draw_uniforms(a, bufs)
    fresh = pm.draw_uniforms(b)
    assert len(raw) == 4 and all(torch.equal(x, y) for x, y in zip(raw, fresh))
    n1, n2 = pm.noise_from_uniforms(raw), pm.draw_noise(pm.generator(1))
    assert torch.equal(n1.g, n2.g) and all(torch.equal(x, y) for x, y in zip(n1.u, n2.u))
    assert torch.equal(a.get_state(), b.get_state())


@pytest.mark.parametrize("S", [1, 2, 3])
def test_staleness_ring_step_over_jobs_matches_jax(S):
    """A ``(J, S, K)`` ring (the multi-job service's) pops slot 0 of every
    job and shifts along the slots, as JAX's ring does on leading batch
    axes: bit for bit over a few ticks."""
    from repro.engine.round_program import staleness_ring_step as jstaleness_ring_step
    from repro_torch.engine import staleness_ring_step

    rng = np.random.default_rng(S)
    J, Kj = 3, 40
    pending = rng.random((J, S, Kj)).astype(np.float32)
    jpending, tpending = jnp.asarray(pending), torch.from_numpy(pending)
    for _ in range(4):
        mask = (rng.random((J, Kj)) < 0.3).astype(np.float32)
        lag = rng.choice(np.arange(-1, S + 1, dtype=np.int32), (J, Kj))
        jarr, jpending = jstaleness_ring_step(jpending, jnp.asarray(mask), jnp.asarray(lag), S, 0.5)
        arr, tpending = staleness_ring_step(tpending, torch.from_numpy(mask), torch.from_numpy(lag), S, 0.5)
        assert arr.shape == (J, Kj) and tpending.shape == (J, S, Kj)
        np.testing.assert_array_equal(arr.numpy(), np.asarray(jarr))
        np.testing.assert_array_equal(tpending.numpy(), np.asarray(jpending))

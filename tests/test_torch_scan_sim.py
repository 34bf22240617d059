"""The slice as a whole: the scenario harness over the whole-horizon runner,
against the JAX package.

UCB is deterministic given the outcomes, so a UCB run replaying a trace JAX
recorded must equal JAX's masks, xs and counts exactly, through
``scan_selection_sim(packed_override=)``, ``async_selection_sim(
packed_lag_override=)`` and ``run_replay`` (given JAX's trace in place of
its own recording).  The harness's metrics are float32 reductions: counts
and CEP exactly, the rest within ``RTOL_METRIC`` (see
``test_torch_fairness.py``).  Runs that draw noise are held against the
port's own references: ``sharded_selection_sim`` on a one-rank gloo mesh
against the dense runner (bit for bit at ``block=1``), ``selection_sim``'s
loop against its runner, and the scenario models' captured horizons against
the step loop.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.engine.scan_sim as jsim
import repro.scenarios as J
from repro.core.volatility import CompletionLag as JCompletionLag
import repro_torch.scenarios as P
from repro_torch.configs import FLConfig
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.core.sim import selection_sim
from repro_torch.engine import RoundProgram, async_selection_sim, scan_selection_sim, sharded_selection_sim
from repro_torch.launch import make_host_mesh
from repro_torch.scenarios import harness

K, k, T, SEED = 1024, 16, 24, 3
RTOL_METRIC = 1e-5


@pytest.fixture(scope="module")
def mesh1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_host_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def _jax_trace(scenario="diurnal"):
    vol, _ = J.make_scenario(scenario, K, T, SEED)
    return J.record_trace(vol, T, seed=SEED, chunk=8)


def test_ucb_replay_equals_jax_exactly():
    packed = _jax_trace()
    got = scan_selection_sim("ucb", K=K, k=k, T=T, packed_override=packed, device="cpu")
    want = jsim.scan_selection_sim("ucb", K=K, k=k, T=T, packed_override=packed)
    for key in ("masks", "xs", "counts", "ps", "sigmas"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


def test_ucb_async_lag_replay_equals_jax_exactly():
    vol, _ = J.make_scenario("flash_crowd", K, T, SEED)
    lags = J.record_lag_trace(JCompletionLag(vol, max_lag=2), T, seed=SEED)
    got = async_selection_sim("ucb", K=K, k=k, T=T, staleness=2, packed_lag_override=lags, device="cpu")
    want = jsim.async_selection_sim("ucb", K=K, k=k, T=T, staleness=2, packed_lag_override=lags)
    for key in ("masks", "lags", "arrived", "on_time", "stale", "sel_counts"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert got["cep"] == want["cep"]


def test_run_replay_of_ucb_equals_jax(monkeypatch):
    """``run_replay`` records its own trace with the port's generator; given
    JAX's recording in its place, UCB's row equals JAX's."""
    packed = _jax_trace()
    monkeypatch.setattr(harness, "record_trace", lambda *a, **kw: packed)
    row, got_packed = P.run_replay("ucb", "diurnal", K=K, k=k, T=T, seed=SEED, device="cpu")
    want, _ = J.run_replay("ucb", "diurnal", K=K, k=k, T=T, seed=SEED)
    np.testing.assert_array_equal(got_packed, packed)
    assert sorted(row) == sorted(want)
    for key, v in want.items():
        if isinstance(v, float) and key != "cep":
            np.testing.assert_allclose(row[key], v, rtol=RTOL_METRIC, err_msg=key)
        else:
            assert row[key] == v, key


def test_run_replay_feeds_every_selector_the_same_bits():
    rows, packed = P.run_replay(("e3cs", "random", "fedcs", "pow_d", "ucb"), "markov", K=K, k=k, T=T, seed=SEED,
                                device="cpu")
    assert [r["selector"] for r in rows] == ["e3cs", "random", "fedcs", "pow_d", "ucb"]
    xs = P.unpack_trace(packed, K)
    for sel in ("random", "ucb"):
        out = scan_selection_sim(sel, K=K, k=k, T=T, frac=0.5, seed=SEED, packed_override=packed, device="cpu")
        np.testing.assert_array_equal(out["xs"], xs)
        assert np.all(out["masks"].sum(1) == k)


@pytest.mark.parametrize("staleness,feedback", [(None, None), (2, None), (2, "late_credit")])
def test_evaluate_cell_rows_have_the_jax_keys(staleness, feedback):
    kw = dict(K=256, k=8, T=12, seed=1, staleness=staleness, feedback=feedback)
    row = P.evaluate_cell("e3cs", "flash_crowd", device="cpu", **kw)
    want = J.evaluate_cell("e3cs", "flash_crowd", **kw)
    assert list(row) == list(want)
    assert all(np.isfinite(v) for v in row.values() if isinstance(v, float))


def test_run_grid_streams_its_rows():
    class Sink:
        rows = []

        def grid_row(self, row):
            self.rows.append(row)

    sink = Sink()
    rows = P.run_grid(("random", "ucb"), ("paper_iid", "regional_outage"), K=256, k=8, T=10, staleness=None,
                      log=sink, device="cpu")
    assert sink.rows == rows and len(rows) == 4
    assert "regional_outage" in P.format_grid(rows)


@pytest.mark.parametrize("volatility", ["bernoulli", "markov", "deadline"])
@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_sharded_sim_on_one_rank_equals_the_dense_run(mesh1, volatility, fused):
    kw = dict(K=K, k=k, T=T, frac=0.5, volatility=volatility, seed=SEED, fused=fused, device="cpu")
    dense = scan_selection_sim("e3cs", allocator="bisect", **kw)
    got = sharded_selection_sim("e3cs", mesh1, block=1, **kw)
    for key in ("masks", "xs", "ps", "sigmas", "counts"):
        np.testing.assert_array_equal(got[key], dense[key], err_msg=key)
    b4 = sharded_selection_sim("e3cs", mesh1, block=4, outputs="lean", **kw)
    assert b4["successes"].shape == (T,) and b4["counts"].sum() == T * k


def test_sharded_sim_refuses_what_the_mesh_does_not_run(mesh1):
    """The baselines and the scenario models run on a mesh (a one-rank mesh
    equals the dense run bit for bit); what it refuses, as JAX does, is a
    model without K-indexed dataclass fields to cut into slabs."""
    kw = dict(K=K, k=k, T=T, frac=0.5, seed=SEED, device="cpu")
    for key, want in scan_selection_sim("fedcs", **kw).items():
        np.testing.assert_array_equal(sharded_selection_sim("fedcs", mesh1, **kw)[key], want, err_msg=key)
    vol, rho = P.make_scenario("diurnal", K, T, device="cpu")
    dense = scan_selection_sim("e3cs", allocator="bisect", vol=vol, rho=rho, **kw)
    got = sharded_selection_sim("e3cs", mesh1, vol=vol, rho=rho, **kw)
    for key in ("masks", "xs", "ps", "sigmas", "counts"):
        np.testing.assert_array_equal(got[key], dense[key], err_msg=key)

    class NotADataclass:
        rho = vol.rho

        def to(self, device):
            return self

        def init_state(self):
            return vol.init_state()

        def draw_rows(self):
            return vol.draw_rows()

    with pytest.raises(TypeError, match="replay traces through"):
        sharded_selection_sim("e3cs", mesh1, K=K, k=k, T=2, vol=NotADataclass(), rho=rho, device="cpu")


@pytest.mark.parametrize("scheme", ["e3cs", "pow_d", "fedcs"])
def test_selection_sim_loop_equals_its_runner(scheme):
    kw = dict(K=256, k=8, T=10, frac=0.5, volatility="markov", seed=2, device="cpu")
    a, b = selection_sim(scheme, backend="scan", **kw), selection_sim(scheme, backend="loop", **kw)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    with pytest.raises(ValueError, match="backend"):
        selection_sim(scheme, backend="eager", **kw)


@pytest.mark.parametrize("scenario", ["diurnal", "regional_outage", "flash_crowd", "deadline"])
@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_scenario_horizon_equals_the_step_loop(scenario, fused):
    """A scenario's state (a round index, a region row, ``(alive, t)``)
    rides the runner's static buffers: a ``carry_key`` horizon in two chunks
    equals the hand loop of ``build_step`` + ``draw_noise``, generator state
    and model state included, and the state crosses ``state_to_numpy`` /
    ``state_from_jax``."""
    fl = FLConfig(K=512, k=8, rounds=16, allocator="bisect", quota_frac=0.5, volatility=scenario, seed=4)
    pm = RoundProgram.from_config(fl, fused=fused, device="cpu")
    run, s0 = pm.build_runner(outputs="full", carry_key=True, scan_length=8)
    st, key, *first = run(s0, SEED)
    crossed, _ = state_from_jax(state_to_numpy(st), device="cpu")
    st2, key2, *second = run(crossed, key)
    step, _ = pm.build_step()
    gen, carry, outs = pm.generator(SEED), (s0,), []
    for _ in range(16):
        carry, out = step(carry, None, pm.draw_noise(gen))
        outs.append(out)
    want = [torch.stack(c) for c in zip(*outs)]
    for got, ref in zip((torch.cat([a, b]) for a, b in zip(first, second)), want):
        assert torch.equal(got, ref)
    assert torch.equal(key2, gen.get_state())
    for a, b in zip(torch.utils._pytree.tree_leaves(st2), torch.utils._pytree.tree_leaves(carry[0])):
        assert torch.equal(a, b)
    assert torch.all(want[0].sum(1) == 8)

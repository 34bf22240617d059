"""The port's FL training stack against the JAX package's: aggregation,
the local update, the cohort rounds and ``FLServer.run``, given JAX's
initial parameters and JAX's own draws.

What is exact.  The E3CS selection never reads the model, so cohorts,
``sel_counts``, ``cep``, the success and lag rows and ``n_late`` are equal
exactly; the log-weights within the allocator's few ulps (``LOGW_ATOL``).

What is not.  Parameters, losses and accuracy are sums of convolutions that
ATen takes in another order than XLA's CPU backend.  While no activation
changes side they agree to ~1e-7 (measured 3e-8 after four E3CS rounds);
when a pre-activation or a max-pool window lies within rounding of a tie,
the two packages route one gradient differently at that step and the
parameters part by up to ~1e-4 from then on (measured 5.4e-5 after four
pow-d rounds, a jump at the seventh step of the first round).  So trained
parameters are held to ``PARAM_RTOL``/``PARAM_ATOL`` on O(0.1-1) values.
pow-d selects on losses: its cohorts are held exactly where every round's
k-th and (k+1)-th candidate losses are further apart than ``LOSS_GAP``.
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFLConfig, get_config as jget_config
from repro.core.volatility import DEAD_LAG
from repro.data import ClientStore as JClientStore, make_image_dataset, partition_primary_label
from repro.fl import FLServer as JFLServer
from repro.fl import aggregate as jaggregate, aggregate_async as jaggregate_async
from repro.fl import make_async_cohort_round as jmake_async_cohort_round, make_cohort_round as jmake_cohort_round
from repro.fl import make_local_update as jmake_local_update
from repro.models import build_model as jbuild_model
from repro.optim import sgd as jsgd
from repro_torch.configs import FLConfig, get_config
from repro_torch.convert import cnn_params_from_jax, cnn_params_to_numpy, fl_state_from_jax
from repro_torch.data import ClientStore
from repro_torch.engine import RoundProgram
from repro_torch.fl import (
    FLServer,
    aggregate,
    aggregate_async,
    make_async_cohort_round,
    make_cohort_round,
    make_local_update,
    staleness_weights,
)
from repro_torch.fl.round import RoundNoise
from repro_torch.models import build_model
from repro_torch.optim import sgd

PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-4
AGG_RTOL, AGG_ATOL = 1e-6, 1e-7  # one tensordot over the cohort, summed in another order
LOGW_ATOL = 1e-6
LOSS_GAP = 1e-3
K, k = 20, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return {n: np.asarray(v) for n, v in tree.items()}


def _assert_params(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL):
    got = cnn_params_to_numpy(got)
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=rtol, atol=atol, err_msg=name)


# -- aggregation ---------------------------------------------------------------

def _agg_inputs(seed=0, kk=5):
    rng = np.random.default_rng(seed)
    g = {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(3,)).astype(np.float32)}
    cohort = {n: (v[None] + rng.normal(size=(kk,) + v.shape)).astype(np.float32) for n, v in g.items()}
    return g, cohort, rng


@pytest.mark.parametrize("scheme", ["mean", "fedavg", "epoch_weighted", "unbiased"])
def test_aggregate_matches_jax(scheme):
    g, cohort, rng = _agg_inputs()
    succ = np.array([1, 0, 1, 1, 0], np.float32)
    sizes = rng.integers(10, 50, 5).astype(np.float32)
    epochs = rng.choice((1, 2, 3, 4), 5).astype(np.float32)
    probs = rng.uniform(0.05, 1.0, 5).astype(np.float32)
    want = jaggregate({n: jnp.asarray(v) for n, v in g.items()}, {n: jnp.asarray(v) for n, v in cohort.items()},
                      jnp.asarray(succ), jnp.asarray(sizes), jnp.float32(400.0), 40, scheme,
                      epochs=jnp.asarray(epochs), sel_probs=jnp.asarray(probs))
    got = aggregate({n: _t(v) for n, v in g.items()}, {n: _t(v) for n, v in cohort.items()}, _t(succ), _t(sizes),
                    torch.tensor(400.0), 40, scheme, epochs=_t(epochs), sel_probs=_t(probs))
    for n in g:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), rtol=AGG_RTOL, atol=AGG_ATOL)


def test_aggregation_hand_cases():
    """``tests/test_fl.py::TestAggregation``'s hand cases on the port."""
    g = {"w": torch.zeros(4, 3), "b": torch.ones(3)}
    cohort = {n: torch.stack([v + 1, v + 2]) for n, v in g.items()}
    out = aggregate(g, cohort, torch.zeros(2), torch.ones(2), torch.tensor(10.0), 10, "fedavg")
    assert all(torch.equal(out[n], g[n]) for n in g)  # all failed keeps the global model
    cohort = {n: torch.stack([v + 1, v - 5]) for n, v in g.items()}
    out = aggregate(g, cohort, torch.tensor([1.0, 0.0]), torch.ones(2), torch.tensor(4.0), 4, "mean")
    for n in g:
        np.testing.assert_allclose(out[n].numpy(), g[n].numpy() + 0.25, rtol=1e-6)
    one = {"w": torch.zeros(())}
    for epochs in ([1.0, 1.0], [1.0, 4.0]):  # total weight preserved
        out = aggregate(one, {"w": torch.tensor([1.0, 1.0])}, torch.ones(2), torch.ones(2), torch.tensor(2.0), 2,
                        "epoch_weighted", epochs=torch.tensor(epochs))
        assert float(out["w"]) == pytest.approx(1.0, rel=1e-5)
    for kk in (1, 3, 6):  # inverse propensity at p = 0.5 over 2k of data: +1 in total
        out = aggregate({"w": torch.zeros(2)}, {"w": torch.ones(kk, 2)}, torch.ones(kk), torch.ones(kk),
                        torch.tensor(2.0 * kk), 2 * kk, "unbiased", sel_probs=torch.full((kk,), 0.5))
        np.testing.assert_allclose(out["w"].numpy(), 1.0, rtol=1e-5)


def test_aggregate_async_hand_cases():
    """``tests/test_async.py::TestAggregateAsync`` and ``TestStalenessCredit
    ::test_staleness_weights`` on the port."""
    lag = torch.tensor([0, 1, 2, 3, DEAD_LAG], dtype=torch.int32)
    np.testing.assert_allclose(staleness_weights(lag, 0.5, 2).numpy(), [1.0, 0.5, 0.25, 0.0, 0.0])
    new, late = aggregate_async({"w": torch.zeros(())}, {"w": torch.tensor([1.0, 2.0, 3.0])},
                                torch.tensor([0, 1, 2], dtype=torch.int32), torch.ones(3), torch.tensor(3.0), 3,
                                "fedavg", alpha=0.5, staleness=2)
    assert float(new["w"]) == pytest.approx(1.0 / 3.0)
    np.testing.assert_allclose(late["w"].numpy(), [1.0 / 3.0, 0.25], rtol=1e-6)
    new, late = aggregate_async({"w": torch.zeros(())}, {"w": torch.tensor([5.0, 7.0])},
                                torch.tensor([DEAD_LAG, 3], dtype=torch.int32), torch.ones(2), torch.tensor(2.0), 2,
                                "fedavg", alpha=0.5, staleness=2)
    assert float(new["w"]) == 0.0 and late["w"].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("S", [0, 1, 3])
def test_aggregate_async_matches_jax_and_s0_is_aggregate(S):
    g, cohort, rng = _agg_inputs(1, 6)
    lag = np.array([0, 1, 2, DEAD_LAG, 3, 0], np.int32)
    sizes = rng.integers(10, 50, 6).astype(np.float32)
    tg, tc = {n: _t(v) for n, v in g.items()}, {n: _t(v) for n, v in cohort.items()}
    jnew, jlate = jaggregate_async({n: jnp.asarray(v) for n, v in g.items()},
                                   {n: jnp.asarray(v) for n, v in cohort.items()}, jnp.asarray(lag),
                                   jnp.asarray(sizes), jnp.float32(300.0), 30, "fedavg", alpha=0.5, staleness=S)
    new, late = aggregate_async(tg, tc, _t(lag), _t(sizes), torch.tensor(300.0), 30, "fedavg", alpha=0.5, staleness=S)
    for n in g:
        np.testing.assert_allclose(new[n].numpy(), np.asarray(jnew[n]), rtol=AGG_RTOL, atol=AGG_ATOL)
        assert late[n].shape == (S,) + g[n].shape
        np.testing.assert_allclose(late[n].numpy(), np.asarray(jlate[n]), rtol=AGG_RTOL, atol=AGG_ATOL)
    if S == 0:
        sync = aggregate(tg, tc, _t((lag == 0).astype(np.float32)), _t(sizes), torch.tensor(300.0), 30, "fedavg")
        assert all(torch.equal(sync[n], new[n]) for n in g)


# -- the local update ------------------------------------------------------------

def _cohort_batches(n_steps=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, n_steps, 8, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 26, (3, n_steps, 8)).astype(np.int32)
    return x, y


@pytest.mark.parametrize("kind", ["fedavg", "fedprox"])
def test_local_update_matches_jax(kind):
    jm, m = jbuild_model(jget_config("emnist-cnn")), build_model(get_config("emnist-cnn"))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    x, y = _cohort_batches()
    mask = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], np.float32)
    jl = jax.vmap(jmake_local_update(jm, jsgd(0.05, 0.9), kind, prox_coef=5.0), in_axes=(None, 0, 0, 0))
    jout, jstats = jl(jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jnp.asarray(mask),
                      jax.random.split(jax.random.PRNGKey(1), 3))
    out, stats = make_local_update(m, sgd(0.05, 0.9), kind, prox_coef=5.0)(
        cnn_params_from_jax(_np_tree(jp), "cpu"), {"x": _t(x), "y": _t(y)}, _t(mask))
    _assert_params(out, jout)
    np.testing.assert_allclose(stats["local_loss"].numpy(), np.asarray(jstats["local_loss"]), rtol=1e-5)


def test_masked_steps_are_bit_identical_noops():
    """A client's masked trailing steps leave its parameters and momentum as
    they were: the run of 2 steps of 4 equals the run of its 2 steps alone
    bit for bit; the fully masked client returns the global parameters."""
    m = build_model(get_config("emnist-cnn"))
    p, _ = m.init(torch.Generator().manual_seed(0))
    x, y = _cohort_batches()
    local = make_local_update(m, sgd(0.05, 0.9))
    half, _ = local(p, {"x": _t(x), "y": _t(y)}, torch.tensor([[1.0, 1, 0, 0]] * 3))
    two, _ = local(p, {"x": _t(x[:, :2]), "y": _t(y[:, :2])}, torch.ones(3, 2))
    none, stats = local(p, {"x": _t(x), "y": _t(y)}, torch.zeros(3, 4))
    for n in p:
        assert torch.equal(half[n], two[n]), n
        assert all(torch.equal(none[n][c], p[n]) for c in range(3)), n
    assert torch.equal(stats["local_loss"], torch.zeros(3))


def test_fedprox_stays_closer_to_global():
    m = build_model(get_config("emnist-cnn"))
    p, _ = m.init(torch.Generator().manual_seed(0))
    x, y = _cohort_batches()
    batches, mask = {"x": _t(x), "y": _t(y)}, torch.ones(3, 4)
    avg, _ = make_local_update(m, sgd(0.05, 0.9), "fedavg")(p, batches, mask)
    prox, _ = make_local_update(m, sgd(0.05, 0.9), "fedprox", prox_coef=5.0)(p, batches, mask)

    def dist(q):
        return sum(float(torch.sum((q[n] - p[n]) ** 2)) for n in p)

    assert dist(prox) < dist(avg)


# -- the cohort rounds and the server, given JAX's draws -------------------------

def _fl(**kw):
    base = dict(K=K, k=k, rounds=4, quota="const", quota_frac=0.5, samples_per_client=40, batch_size=10,
                local_epochs=(1, 2))
    base.update(kw)
    return JFLConfig(**base), FLConfig(**base)


def _data():
    d = make_image_dataset(26, (28, 28, 1), 600, 200, seed=0)
    return d, partition_primary_label(d["y"], K, 40, seed=0)


def _vol_rows(fl, k_round):
    """The volatility model's rows JAX draws from a round key: its model
    key is ``split(fold_in(rng, 1))[0]``; ``CompletionLag`` splits it in
    three (base, late, lag)."""
    r_vol = jax.random.split(jax.random.fold_in(k_round, 1))[0]
    if fl.staleness_rounds == 0:
        return (_t(jax.random.uniform(r_vol, (fl.K,), jnp.float32)),)
    r_base, r_late, r_lag = jax.random.split(r_vol, 3)
    return (_t(jax.random.uniform(r_base, (fl.K,), jnp.float32)), _t(jax.random.uniform(r_late, (fl.K,), jnp.float32)),
            _t(jax.random.uniform(r_lag, (fl.K,), jnp.float32, minval=1e-7, maxval=1.0)))


def _server_noise(fl, rounds):
    """``FLServer.run``'s draws as JAX makes them: the key from ``seed + 1``
    split four ways a round (the selection's, the round's, pow-d's
    candidates)."""
    key = jax.random.PRNGKey(fl.seed + 1)
    out = []
    for _ in range(rounds):
        key, k_sel, k_round, k_cand = jax.random.split(key, 4)
        sel = {}
        if fl.scheme == "e3cs":
            sel["g"] = _t(jax.random.gumbel(k_sel, (fl.K,), jnp.float32))
        elif fl.scheme == "pow_d":
            sel["perm"] = _t(jax.random.permutation(k_sel, fl.K)).long()
        cand = _t(jax.random.permutation(k_cand, fl.K)).long() if fl.scheme == "pow_d" else None
        out.append((RoundNoise(u=_vol_rows(fl, k_round), **sel), cand))
    return out


def _state_arrays(js):
    return {"logw": js.e3cs.logw, "t": js.t, "sel_counts": js.sel_counts, "loss_cache": js.loss_cache,
            "vol_state": js.vol_state, "cep": js.cep, "succ_hist": js.succ_hist, "params": _np_tree(js.params)}


def _port_state(js):
    state, _ = fl_state_from_jax(jax.tree.map(np.asarray, _state_arrays(js)), "cpu")
    return state


@pytest.mark.parametrize("S", [0, 2], ids=["sync", "async"])
def test_cohort_round_matches_jax(S):
    """One round of each factory from the same state and batches: the JAX
    round takes its key, the port the key's volatility rows."""
    jfl, fl = _fl(staleness_rounds=S, late_prob=0.9)
    d, idxs = _data()
    jsrv = JFLServer(jbuild_model(jget_config("emnist-cnn")), jfl, JClientStore(d, idxs))
    js = jsrv.init_state(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(3)
    idx, p, capped, sigma = jsrv._select(js, key)
    xb, yb, mask = JClientStore(d, idxs).round_batches(np.asarray(idx), jsrv.epochs, fl.batch_size, jsrv.n_steps)
    sizes = jsrv.store.sizes()[np.asarray(idx)]
    epochs = jsrv.epochs[np.asarray(idx)].astype(np.float32)
    pm = RoundProgram.from_config(fl, device="cpu")
    if S:
        _, jround = jmake_async_cohort_round(jsrv.model, jfl, jsrv.quota, jsrv.lag_model, jsrv.rho)
        _, round_fn = make_async_cohort_round(build_model(get_config("emnist-cnn")), fl, pm.quota_fn, pm.lag_model, pm.rho)
    else:
        _, jround = jmake_cohort_round(jsrv.model, jfl, jsrv.quota, jsrv.vol, jsrv.rho)
        _, round_fn = make_cohort_round(build_model(get_config("emnist-cnn")), fl, pm.quota_fn, pm.base_vol, pm.rho)
    k_round = jax.random.PRNGKey(4)
    jout = jround(js, idx, p, capped, sigma, {"x": jnp.asarray(xb), "y": jnp.asarray(yb)}, jnp.asarray(mask),
                  jnp.asarray(sizes), jnp.float32(800.0), jnp.asarray(epochs), k_round)
    out = round_fn(_port_state(js), _t(idx), _t(p), _t(capped), _t(sigma), {"x": _t(xb), "y": _t(yb)}, _t(mask),
                   _t(sizes), torch.tensor(800.0), _t(epochs), _vol_rows(fl, k_round))
    (jst, jmet), (st, met) = jout[:2], out[:2]
    _assert_params(st.params, jst.params)
    np.testing.assert_array_equal(st.sel_counts.numpy(), np.asarray(jst.sel_counts))
    assert float(st.cep) == float(jst.cep) and float(met["n_success"]) == float(jmet["n_success"])
    np.testing.assert_allclose(st.e3cs.logw.numpy(), np.asarray(jst.e3cs.logw), rtol=1e-6, atol=LOGW_ATOL)
    got_cache, want_cache = st.loss_cache.numpy(), np.asarray(jst.loss_cache)
    assert np.array_equal(got_cache == 1e9, want_cache == 1e9)
    np.testing.assert_allclose(got_cache, want_cache, rtol=PARAM_RTOL)
    if S:
        assert float(met["n_late"]) == float(jmet["n_late"])
        for name, late in out[2].items():
            assert late.shape[0] == S
            np.testing.assert_allclose(cnn_params_to_numpy({name: late})[name], np.asarray(jout[2][name]),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL)


def _fixed_report(self, state, rng):
    """JAX's pow-d candidate stage with its cache copied before the write:
    under jax 0.9 ``np.asarray`` of a device array is read-only and the
    reference's own ``cache[cand] = ...`` raises (ROADMAP §C)."""
    d = self.cfg.pow_d
    cand = np.asarray(jax.random.permutation(rng, self.cfg.K))[:d]
    xb, yb, _ = self.store.round_batches(cand, np.ones(self.cfg.K, np.int32), self.cfg.batch_size)
    losses = self._cand_loss(state.params, {"x": jnp.asarray(xb[:, 0]), "y": jnp.asarray(yb[:, 0])})
    cache = np.array(state.loss_cache)
    cache[cand] = np.asarray(losses)
    self.cand_losses.append(np.sort(cache[cand])[::-1])
    return state._replace(loss_cache=jnp.asarray(cache))


SERVER_CASES = {"e3cs-sync": dict(scheme="e3cs"), "e3cs-async-S2": dict(scheme="e3cs", staleness_rounds=2, late_prob=0.9),
                "pow_d": dict(scheme="pow_d")}


@pytest.mark.parametrize("case", list(SERVER_CASES))
def test_server_run_matches_jax_given_its_draws(case):
    jfl, fl = _fl(**SERVER_CASES[case])
    d, idxs = _data()
    jm = jbuild_model(jget_config("emnist-cnn"))
    jx, jy = JClientStore(d, idxs).eval_batch(200)

    def jeval(params):
        logits = jm.forward(params, {"x": jnp.asarray(jx)})
        return float((jnp.argmax(logits, -1) == jnp.asarray(jy)).mean()), 0.0

    jsrv = JFLServer(jm, jfl, JClientStore(d, idxs), jeval)
    jsrv.cand_losses = []
    jsrv._report_candidate_losses = types.MethodType(_fixed_report, jsrv)
    jidx, pidx = [], []
    jselect = jsrv._select
    jsrv._select = lambda s, r: (lambda out: (jidx.append(np.asarray(out[0])), out)[1])(jselect(s, r))
    js0 = jsrv.init_state(jax.random.PRNGKey(0))
    js, jh = jsrv.run(js0, eval_every=2)

    m = build_model(get_config("emnist-cnn"))
    x, y = ClientStore(d, idxs).eval_batch(200)

    def peval(params):
        return float(torch.mean((torch.argmax(m.forward(params, {"x": _t(x)}), -1) == _t(y)).float())), 0.0

    srv = FLServer(m, fl, ClientStore(d, idxs), peval, device="cpu")
    select = srv._select
    srv._select = lambda s, n: (lambda out: (pidx.append(out[0].numpy()), out)[1])(select(s, n))
    st, h = srv.run(_port_state(js0), eval_every=2, noise=_server_noise(fl, fl.rounds))

    if case == "pow_d":  # cohorts are held where the k-th candidate loss is clear of the next
        gaps = [c[fl.k - 1] - c[fl.k] for c in jsrv.cand_losses]
        assert min(gaps) > LOSS_GAP, gaps
    for a, b in zip(pidx, jidx):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(st.sel_counts.numpy(), np.asarray(js.sel_counts))
    assert float(st.cep) == float(js.cep) and float(st.succ_hist) == float(js.succ_hist)
    assert h["round"] == jh["round"] and h["cep"] == jh["cep"]
    np.testing.assert_allclose(h["acc"], jh["acc"], atol=0.01)  # 2 of 200 predictions may change
    np.testing.assert_allclose(st.e3cs.logw.numpy(), np.asarray(js.e3cs.logw), rtol=1e-6, atol=LOGW_ATOL)
    if fl.staleness_rounds:
        assert h["n_late"] == jh["n_late"] > 0
    _assert_params(st.params, js.params)


def test_train_main_on_cpu(tmp_path):
    out = tmp_path / "run.json"
    ckpt = tmp_path / "final.ckpt"
    main_args = ["--task", "emnist", "--rounds", "2", "--K", "10", "--k", "3", "--spc", "20", "--batch", "10",
                       "--epochs", "1", "--eval-every", "1", "--device", "cpu", "--out", str(out), "--ckpt", str(ckpt)]
    from repro_torch.checkpoint import restore
    from repro_torch.core.selection import e3cs_init
    from repro_torch.launch.train import main

    res = main(main_args)
    saved = json.loads(out.read_text())
    assert saved["device"] == "cpu" and saved["history"]["round"] == [1, 2] and len(saved["sel_counts"]) == 10
    assert res["cep"] == saved["cep"] and sum(saved["sel_counts"]) == 6
    like = {"params": build_model(get_config("emnist-cnn")).init(torch.Generator().manual_seed(1))[0],
            "e3cs": e3cs_init(10, "cpu")}
    tree = restore(str(ckpt), like)
    assert list(tree["params"]) == ["conv1", "b1", "conv2", "b2", "fc1", "fb1", "fc2", "fb2", "head", "hb"]
    assert int(tree["e3cs"].t) == 2 and all(torch.isfinite(v).all() for v in tree["params"].values())

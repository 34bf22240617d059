"""Federated training of the zoo's language models in the port against the
JAX package: the optimizers, aggregation and FedProx over nested parameter
trees; ``make_local_update`` over the gemma and qwen3-moe smokes (the
cohort's ``vmap`` of ``grad_and_value`` through the rematerialised layers)
against JAX's vmapped ``local_train``; two rounds of ``make_cohort_round``
as ``examples/fl_lm.py`` runs them, and one of ``make_async_cohort_round``,
given JAX's draws; ``make_silo_steps`` over two clients against JAX's.

What is exact.  The E3CS selection never reads the model: cohorts, masks,
``sel_counts``, ``cep`` and the success and lag rows equal JAX's exactly,
and the log-weights to the allocator's ulps (``LOGW_ATOL``, as
``test_torch_fl.py``).  Trees: the nested tree's leaves equal the same
leaves in a flat dict bit for bit.

What is not.  Parameters and losses are sums of float32 products that XLA
and ATen take in other orders (``torch_zoo_common.GRAD_TOL``); elementwise
optimizer steps and one ``tensordot`` over the cohort agree to a few ulps
(``ELEM_TOL``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import FLConfig as JFLConfig, get_config as jget_config, smoke_variant as jsmoke_variant
from repro.core.selection import make_quota_schedule as jmake_quota_schedule
from repro.core.volatility import BernoulliVolatility as JBernoulli, DEAD_LAG, paper_success_rates
from repro.data import lm_client_batches as jlm_client_batches, make_lm_dataset as jmake_lm_dataset
from repro.engine import RoundProgram as JRoundProgram
from repro.fl import aggregate as jaggregate, aggregate_async as jaggregate_async
from repro.fl import init_server_state as jinit_server_state, make_async_cohort_round as jmake_async_cohort_round
from repro.fl import make_cohort_round as jmake_cohort_round, make_local_update as jmake_local_update
from repro.fl import make_silo_steps as jmake_silo_steps, prox_penalty as jprox_penalty
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw, sgd as jsgd
from repro_torch.configs import FLConfig, get_config, smoke_variant
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.selection import make_quota_schedule
from repro_torch.core.volatility import BernoulliVolatility
from repro_torch.data import lm_client_batches, make_lm_dataset
from repro_torch.engine import RoundProgram
from repro_torch.fl import aggregate, aggregate_async, init_server_state, make_async_cohort_round, \
    make_cohort_round, make_local_update, make_silo_steps, prox_penalty
from repro_torch.fl.round import RoundNoise
from repro_torch.models import build_model
from repro_torch.optim import adamw, sgd
from torch_zoo_common import GRAD_TOL, assert_tree_close

ELEM_TOL = dict(rtol=1e-6, atol=1e-7)
LOGW_ATOL = 1e-6
LM_ARCHS = ["gemma-2b", "qwen3-moe-30b-a3b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _nested(seed=0, lead=()):
    """A small nested tree the shape of a zoo model's (a stacked segment, a
    norm, an embedding), float32, from a numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = {"tok_emb": (6, 4), "final_norm": (4,),
              "seg0": {"attn": {"wq": (2, 4, 3), "wo": (2, 3, 4)}, "norm1": (2, 4)}}

    def draw(s):
        return {k: draw(v) for k, v in s.items()} if isinstance(s, dict) else \
            rng.normal(size=lead + s).astype(np.float32)

    return draw(shapes)


def _to_torch(tree):
    return pytree.tree_map(_t, tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    """The same leaves in a flat dict, keyed by path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_same_leaves(nested, flat):
    """A result over the nested tree equals the result over its flat dict bit for bit."""
    got = _flat(nested)
    assert got.keys() == flat.keys()
    for k in flat:
        assert torch.equal(got[k], flat[k]), k


# -- the substrates over nested trees -------------------------------------------

OPTIMIZERS = {"sgd": lambda m: m.sgd(0.05, momentum=0.9), "sgd-nesterov-wd": lambda m: m.sgd(
    0.05, momentum=0.9, nesterov=True, weight_decay=0.01), "sgd-plain": lambda m: m.sgd(0.05),
              "adamw": lambda m: m.adamw(1e-2)}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizers_on_a_nested_tree_match_jax(name):
    import types

    p0, grads = _nested(0), [_nested(s) for s in (1, 2, 3)]
    jopt = OPTIMIZERS[name](types.SimpleNamespace(sgd=jsgd, adamw=jadamw))
    opt = OPTIMIZERS[name](types.SimpleNamespace(sgd=sgd, adamw=adamw))
    jp, p = _to_jax(p0), _to_torch(p0)
    js, st = jopt.init(jp), opt.init(p)
    fp, fs = _flat(p), opt.init(_flat(p))
    for i, g in enumerate(grads):
        jp, js = jopt.update(jp, _to_jax(g), js, i)
        p, st = opt.update(p, _to_torch(g), st, i)
        fp, fs = opt.update(fp, _flat(_to_torch(g)), fs, i)
    assert_tree_close(p, jp, **ELEM_TOL)
    _assert_same_leaves(p, fp)


@pytest.mark.parametrize("scheme", ["mean", "fedavg", "epoch_weighted", "unbiased"])
def test_aggregate_on_a_nested_tree_matches_jax(scheme):
    g, cohort = _nested(0), _nested(1, lead=(5,))
    rng = np.random.default_rng(2)
    succ = np.array([1, 0, 1, 1, 0], np.float32)
    sizes = rng.integers(10, 50, 5).astype(np.float32)
    epochs = rng.choice((1, 2, 3, 4), 5).astype(np.float32)
    probs = rng.uniform(0.05, 1.0, 5).astype(np.float32)
    args = (_t(succ), _t(sizes), torch.tensor(400.0), 40, scheme)
    kw = dict(epochs=_t(epochs), sel_probs=_t(probs))
    want = jaggregate(_to_jax(g), _to_jax(cohort), jnp.asarray(succ), jnp.asarray(sizes), jnp.float32(400.0), 40,
                      scheme, epochs=jnp.asarray(epochs), sel_probs=jnp.asarray(probs))
    got = aggregate(_to_torch(g), _to_torch(cohort), *args, **kw)
    assert_tree_close(got, want, **ELEM_TOL)
    _assert_same_leaves(got, aggregate(_flat(_to_torch(g)), _flat(_to_torch(cohort)), *args, **kw))


@pytest.mark.parametrize("S", [0, 2])
def test_aggregate_async_on_a_nested_tree_matches_jax(S):
    g, cohort = _nested(0), _nested(1, lead=(6,))
    lag = np.array([0, 1, 2, DEAD_LAG, 3, 0], np.int32)
    sizes = np.random.default_rng(3).integers(10, 50, 6).astype(np.float32)
    jnew, jlate = jaggregate_async(_to_jax(g), _to_jax(cohort), jnp.asarray(lag), jnp.asarray(sizes),
                                   jnp.float32(300.0), 30, "fedavg", alpha=0.5, staleness=S)
    args = (_t(lag), _t(sizes), torch.tensor(300.0), 30, "fedavg")
    new, late = aggregate_async(_to_torch(g), _to_torch(cohort), *args, alpha=0.5, staleness=S)
    assert_tree_close(new, jnew, **ELEM_TOL)
    assert all(t.shape[0] == S for t in pytree.tree_leaves(late))
    assert_tree_close(late, jlate, **ELEM_TOL)
    fnew, flate = aggregate_async(_flat(_to_torch(g)), _flat(_to_torch(cohort)), *args, alpha=0.5, staleness=S)
    _assert_same_leaves(new, fnew)
    _assert_same_leaves(late, flate)


def test_prox_penalty_on_a_nested_tree_matches_jax():
    """FedProx's squared distance sums its leaves in ``jax.tree.reduce``'s
    order (a dict's keys sorted at every level), as JAX's does."""
    a, b = _nested(0), _nested(1)
    want = jprox_penalty(_to_jax(a), _to_jax(b))
    got = prox_penalty(_to_torch(a), _to_torch(b))
    np.testing.assert_allclose(float(got), float(want), **ELEM_TOL)
    flat = prox_penalty(_flat(_to_torch(a)), _flat(_to_torch(b)))
    assert torch.equal(got, flat)  # the flat keys sort as the nested ones do


# -- the zoo's local update and rounds --------------------------------------------

def _lm_configs(arch, **over):
    over.setdefault("remat", True)
    return (dataclasses.replace(jsmoke_variant(jget_config(arch)), **over),
            dataclasses.replace(smoke_variant(get_config(arch)), **over))


def _lm_models(arch, **over):
    jcfg, cfg = _lm_configs(arch, **over)
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    return jm, m, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _token_batches(vocab, k, n_steps, B, S, seed=0):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, vocab, (k, n_steps, B, S)).astype(np.int32)
    return {"tokens": blocks, "labels": blocks}


@pytest.mark.parametrize("kind", ["fedavg", "fedprox"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_local_update_over_the_zoo_matches_jax(arch, kind):
    """Three clients, three steps, the last client's third step masked: the
    first step maps over the batches only (every client holds the global
    parameters), the masked step blends the nested stacks back."""
    jm, m, jp, p = _lm_models(arch)
    b = _token_batches(jm.cfg.vocab, 3, 3, 2, 16)
    mask = np.array([[1, 1, 1], [1, 1, 1], [1, 1, 0]], np.float32)
    jl = jax.vmap(jmake_local_update(jm, jsgd(0.05, 0.9), kind, prox_coef=5.0), in_axes=(None, 0, 0, 0))
    jout, jstats = jax.jit(jl)(jp, {k: jnp.asarray(v) for k, v in b.items()}, jnp.asarray(mask),
                               jax.random.split(jax.random.PRNGKey(1), 3))
    out, stats = make_local_update(m, sgd(0.05, 0.9), kind, prox_coef=5.0)(p, {k: _t(v) for k, v in b.items()},
                                                                          _t(mask))
    assert_tree_close(out, jout, **GRAD_TOL)
    np.testing.assert_allclose(stats["local_loss"].numpy(), np.asarray(jstats["local_loss"]), **GRAD_TOL)


def _vol_rows(fl, k_round):
    """The volatility model's rows JAX draws from a round key (as
    ``test_torch_fl.py``): ``split(fold_in(rng, 1))[0]``, split in three by
    ``CompletionLag``."""
    r_vol = jax.random.split(jax.random.fold_in(k_round, 1))[0]
    if fl.staleness_rounds == 0:
        return (_t(jax.random.uniform(r_vol, (fl.K,), jnp.float32)),)
    r_base, r_late, r_lag = jax.random.split(r_vol, 3)
    return (_t(jax.random.uniform(r_base, (fl.K,), jnp.float32)), _t(jax.random.uniform(r_late, (fl.K,), jnp.float32)),
            _t(jax.random.uniform(r_lag, (fl.K,), jnp.float32, minval=1e-7, maxval=1.0)))


FL_LM = dict(K=32, k=8, rounds=25, scheme="e3cs", lr=5e-3)  # examples/fl_lm.py's defaults
FL_LM_RUN = dict(n_steps=2, batch=8, seq=64)


@pytest.mark.parametrize("arch", LM_ARCHS + ["stablelm-1.6b"])
def test_cohort_rounds_of_an_lm_match_jax(arch):
    """``examples/fl_lm.py``'s first two rounds (its config, data, quota and
    volatility; stablelm is its own arch) in both packages, the port given
    JAX's Gumbel rows and volatility rows."""
    jm, m, jp, p = _lm_models(arch)
    jfl, fl = JFLConfig(**FL_LM), FLConfig(**FL_LM)
    rho = paper_success_rates(fl.K)
    jvol, vol = JBernoulli(jnp.asarray(rho)), BernoulliVolatility(_t(rho))
    jselect, jround = jmake_cohort_round(jm, jfl, jmake_quota_schedule("inc", fl.k, fl.K, fl.rounds), jvol,
                                         jnp.asarray(rho))
    select, round_fn = make_cohort_round(m, fl, make_quota_schedule("inc", fl.k, fl.K, fl.rounds, device="cpu"),
                                         vol, _t(rho))
    jselect, jround = jax.jit(jselect), jax.jit(jround)
    jstream = jmake_lm_dataset(jm.cfg.vocab, 200_000, n_chains=fl.K, seed=0)
    stream = make_lm_dataset(m.cfg.vocab, 200_000, n_chains=fl.K, seed=0)
    js = jinit_server_state(jp, fl.K, jvol.init_state())
    st = init_server_state(p, fl.K, vol.init_state(), device="cpu")
    key = jax.random.PRNGKey(1)
    n, B, S = FL_LM_RUN["n_steps"], FL_LM_RUN["batch"], FL_LM_RUN["seq"]
    for t in range(2):
        key, k1, k2 = jax.random.split(key, 3)
        jidx, jpr, jcapped, jsigma = jselect(js, k1)
        idx, pr, capped, sigma = select(st, RoundNoise(g=_t(jax.random.gumbel(k1, (fl.K,), jnp.float32))))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(capped.numpy(), np.asarray(jcapped))
        jblocks = jlm_client_batches(jstream, fl.K, np.asarray(jidx), n, B, S, seed=t)
        blocks = lm_client_batches(stream, fl.K, idx.numpy(), n, B, S, seed=t)
        np.testing.assert_array_equal(blocks, jblocks)
        js, jmet = jround(js, jidx, jpr, jcapped, jsigma, {"tokens": jnp.asarray(jblocks[..., :-1]),
                                                           "labels": jnp.asarray(jblocks[..., :-1])},
                          jnp.ones((fl.k, n), jnp.float32), jnp.full((fl.k,), 1.0), jnp.float32(fl.K),
                          jnp.ones((fl.k,)), k2)
        tok = _t(blocks[..., :-1])
        st, met = round_fn(st, idx, pr, capped, sigma, {"tokens": tok, "labels": tok}, torch.ones(fl.k, n),
                           torch.ones(fl.k), torch.tensor(float(fl.K)), torch.ones(fl.k), _vol_rows(fl, k2))
        np.testing.assert_array_equal(st.sel_counts.numpy(), np.asarray(js.sel_counts))
        assert float(st.cep) == float(js.cep) and float(met["n_success"]) == float(jmet["n_success"])
        np.testing.assert_allclose(st.e3cs.logw.numpy(), np.asarray(js.e3cs.logw), rtol=1e-6, atol=LOGW_ATOL)
        np.testing.assert_allclose(float(met["mean_local_loss"]), float(jmet["mean_local_loss"]), **GRAD_TOL)
        assert_tree_close(st.params, js.params, **GRAD_TOL)
    assert int(st.t) == 2 and float(st.sel_counts.sum()) == 2 * fl.k


def test_async_cohort_round_of_an_lm_matches_jax():
    """One staleness-aware round (S = 2) of the gemma smoke: late deltas as
    nested trees with a leading ``(S,)`` axis, against JAX's."""
    jm, m, jp, p = _lm_models("gemma-2b")
    kw = dict(FL_LM, staleness_rounds=2, late_prob=0.9)
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    jpm, pm = JRoundProgram.from_config(jfl), RoundProgram.from_config(fl, device="cpu")
    jselect, jround = jmake_async_cohort_round(jm, jfl, jpm.quota_fn, jpm.lag_model, jpm.rho)
    select, round_fn = make_async_cohort_round(m, fl, pm.quota_fn, pm.lag_model, pm.rho)
    js = jinit_server_state(jp, fl.K, jpm.lag_model.init_state())
    st = init_server_state(p, fl.K, pm.lag_model.init_state(), device="cpu")
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    jidx, jpr, jcapped, jsigma = jselect(js, k1)
    idx, pr, capped, sigma = select(st, RoundNoise(g=_t(jax.random.gumbel(k1, (fl.K,), jnp.float32))))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    b = _token_batches(m.cfg.vocab, fl.k, 2, 2, 16, seed=4)
    ones = np.ones(fl.k, np.float32)
    jout = jax.jit(jround)(js, jidx, jpr, jcapped, jsigma, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.ones((fl.k, 2)), jnp.asarray(ones), jnp.float32(fl.K), jnp.asarray(ones), k2)
    out = round_fn(st, idx, pr, capped, sigma, {k: _t(v) for k, v in b.items()}, torch.ones(fl.k, 2), _t(ones),
                   torch.tensor(float(fl.K)), _t(ones), _vol_rows(fl, k2))
    (jst, jmet, jlate), (st, met, late) = jout, out
    assert float(met["n_late"]) == float(jmet["n_late"]) > 0
    assert float(met["n_success"]) == float(jmet["n_success"])
    assert_tree_close(st.params, jst.params, **GRAD_TOL)
    assert all(t.shape[0] == 2 for t in pytree.tree_leaves(late))
    assert_tree_close(late, jlate, **GRAD_TOL)


def test_silo_steps_match_jax():
    """The qwen3-moe smoke (scatter MoE, remat) on the silo mapping: two
    clients of two local steps each, their weighted deltas accumulated in
    float32 and applied, against JAX's ``make_silo_steps``; the update
    equals a hand sum of the deltas."""
    jm, m, jp, p = _lm_models("qwen3-moe-30b-a3b")
    jfl, fl = JFLConfig(K=8, k=2, lr=1e-2, momentum=0.9), FLConfig(K=8, k=2, lr=1e-2, momentum=0.9)
    jlocal, jinit, jaccum, japply = jmake_silo_steps(jm, jfl)
    local, init, accum, apply = make_silo_steps(m, fl)
    jaccum, japply = jax.jit(jaccum), jax.jit(japply)
    jstep = jax.jit(jlocal)
    jacc = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), jp)
    acc = pytree.tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32), p)
    weights, locals_ = (0.25, 0.75), []
    for c, w in enumerate(weights):
        b = _token_batches(m.cfg.vocab, 2, 1, 2, 16, seed=10 + c)
        jq, js, q, s = jp, jinit(jp), p, init(p)
        for i in range(2):
            jq, js, jl = jstep(jq, js, {k: jnp.asarray(v[i, 0]) for k, v in b.items()}, i, jax.random.PRNGKey(i))
            q, s, l = local(q, s, {k: _t(v[i, 0]) for k, v in b.items()}, i)
            np.testing.assert_allclose(float(l), float(jl), **GRAD_TOL)
            assert_tree_close(q, jq, **GRAD_TOL)
        jacc, acc = jaccum(jacc, jq, jp, w), accum(acc, q, p, w)
        assert all(t.dtype == torch.float32 for t in pytree.tree_leaves(acc))
        locals_.append(q)
    assert_tree_close(acc, jacc, **GRAD_TOL)
    new = apply(p, acc)
    assert_tree_close(new, japply(jp, jacc), **GRAD_TOL)
    hand = pytree.tree_map(lambda g, a, b: (g + (0.25 * (a - g) + 0.75 * (b - g))), p, *locals_)
    for a, b in zip(pytree.tree_leaves(new), pytree.tree_leaves(hand)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)

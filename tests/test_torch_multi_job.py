"""The batched multi-tenant engine against the JAX package's
``repro.engine.multi_job``, on JAX's own test mix (``tests/test_engine.py``).

The packing and slot edits give JAX's arrays exactly.  The batched step,
handed the Gumbel rows JAX draws from ``fold_in(base_keys[j], t)``, selects
JAX's cohorts exactly (``idx`` and ``mask``); ``logw`` and ``p`` are held to
JAX's own batched-vs-single tolerances (``LOGW_ATOL``, ``P_ATOL``): the
frameworks sum the bisection's tiles in other orders.  Within the port the
batched step equals J independent ``job_step`` calls bit for bit: each
row's sums are taken as the row's own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.volatility import paper_success_rates as jpaper_success_rates
from repro.engine import multi_job as jmj
from repro_torch.core.volatility import paper_success_rates
from repro_torch.engine import (
    MultiJobConfig,
    make_multi_job,
    masked_prob_alloc,
    multi_job_init,
    pack_jobs,
    pad_slots,
    slot_admit,
    slot_retire,
)

LOGW_ATOL, P_ATOL = 1e-5, 1e-6  # tests/test_engine.py's batched-vs-single tolerances
MIX = ([37, 64, 100], [5, 9, 20], [0.0, 0.5, 0.8], [0.5, 0.5, 0.3])


def _np(tree):
    return [np.asarray(v) for v in tree]


def _same(cfg, jcfg):
    for a, b in zip(_np(t.numpy() for t in cfg), _np(jcfg)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pack_and_slot_edits_equal_jax():
    cfg, k_max = pack_jobs(*MIX, device="cpu")
    jcfg, jk_max = jmj.pack_jobs(*MIX)
    assert k_max == jk_max
    _same(cfg, jcfg)
    cfg2, jcfg2 = slot_admit(cfg, 1, 50, 7, 0.8, 0.4), jmj.slot_admit(jcfg, 1, 50, 7, 0.8, 0.4)
    _same(cfg2, jcfg2)
    _same(cfg, jcfg)  # a new config: the old one is unchanged
    _same(slot_retire(cfg2, 0), jmj.slot_retire(jcfg2, 0))
    state = multi_job_init(cfg)
    state = state._replace(logw=torch.randn(state.logw.shape), t=torch.tensor([3, 4, 5], dtype=torch.int32))
    jstate = jmj.MultiJobState(logw=jnp.asarray(state.logw.numpy()), t=jnp.asarray(state.t.numpy()))
    (pc, ps), (jpc, jps) = pad_slots(cfg, state, 5), jmj.pad_slots(jcfg, jstate, 5)
    _same(pc, jpc)
    _same(ps, jps)
    for bad in (dict(K=101, k=5), dict(K=10, k=11), dict(K=10, k=0)):
        with pytest.raises(ValueError):
            slot_admit(cfg, 0, sigma_frac=0.5, eta=0.5, **bad)
    with pytest.raises(ValueError, match="shrink"):
        pad_slots(cfg, state, 2)


def _jax_gumbel(base_keys, t, K_max):
    keys = jax.vmap(lambda kk: jax.random.fold_in(kk, t))(base_keys)
    return keys, torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(kk, (K_max,), jnp.float32))
                                            for kk in keys]))


def test_batched_step_equals_jax_given_its_gumbel_rows():
    cfg, k_max = pack_jobs(*MIX, device="cpu")
    jcfg, _ = jmj.pack_jobs(*MIX)
    _, batched = make_multi_job(k_max)
    _, jbatched = jmj.make_multi_job(k_max)
    state, jstate = multi_job_init(cfg), jmj.multi_job_init(jcfg)
    J, K_max = cfg.active.shape
    rng = np.random.default_rng(0)
    base_keys = jax.random.split(jax.random.PRNGKey(42), J)
    for t in range(15):
        keys, gs = _jax_gumbel(base_keys, t, K_max)
        xs = (rng.random((J, K_max)) < 0.6).astype(np.float32)
        jstate, jout = jbatched(jcfg, jstate, keys, jnp.asarray(xs))
        state, out = batched(cfg, state, gs, torch.from_numpy(xs))
        np.testing.assert_array_equal(out["idx"].numpy(), np.asarray(jout["idx"]), err_msg=f"tick {t}")
        np.testing.assert_array_equal(out["mask"].numpy(), np.asarray(jout["mask"]), err_msg=f"tick {t}")
        np.testing.assert_array_equal(out["capped"].numpy(), np.asarray(jout["capped"]))
        np.testing.assert_allclose(out["p"].numpy(), np.asarray(jout["p"]), rtol=0, atol=P_ATOL)
        np.testing.assert_allclose(state.logw.numpy(), np.asarray(jstate.logw), rtol=0, atol=LOGW_ATOL)
        np.testing.assert_array_equal(state.t.numpy(), np.asarray(jstate.t))


def test_batched_step_equals_independent_single_jobs():
    """The acceptance criterion of JAX's test, held bit for bit here."""
    cfg, k_max = pack_jobs(*MIX, device="cpu")
    job_step, batched = make_multi_job(k_max)
    state = multi_job_init(cfg)
    J, K_max = cfg.active.shape
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(1)
    single = [(state.logw[j], state.t[j]) for j in range(J)]
    for t in range(15):
        gs = -torch.log(-torch.log(torch.rand((J, K_max), generator=gen).clamp(min=1e-38)))
        xs = torch.from_numpy((rng.random((J, K_max)) < 0.6).astype(np.float32))
        state, out = batched(cfg, state, gs, xs)
        for j in range(J):
            row = MultiJobConfig(*(v[j] for v in cfg))
            lw, tt, o = job_step(row, single[j][0], single[j][1], gs[j], xs[j])
            single[j] = (lw, tt)
            for name in ("idx", "mask", "p", "capped"):
                assert torch.equal(o[name], out[name][j]), (t, j, name)
            assert torch.equal(lw, state.logw[j]) and int(tt) == int(state.t[j])


def test_allocator_rows_are_each_rows_own_allocation():
    rng = np.random.default_rng(5)
    J, K = 3, 20_000  # three tiles a row, the last one ragged
    w = torch.from_numpy(rng.gamma(0.3, 1.0, (J, K)).astype(np.float32))
    active = torch.from_numpy((rng.random((J, K)) < 0.9).astype(np.float32))
    k = torch.tensor([100, 2000, 7], dtype=torch.float32)
    sigma = torch.tensor([0.0, 0.5 * 2000 / K, 0.2 * 7 / K])
    p, capped = masked_prob_alloc(w, k, sigma, active=active)
    assert bool(capped.any())
    for j in range(J):
        pj, cj = masked_prob_alloc(w[j], k[j], sigma[j], active=active[j])
        assert torch.equal(p[j], pj) and torch.equal(capped[j], cj)
    with pytest.raises(ValueError, match="block=1"):
        masked_prob_alloc(w, k, sigma, active=active, block=4)


def test_padding_invariants():
    Ks, ks = MIX[0], MIX[1]
    cfg, k_max = pack_jobs(*MIX, device="cpu")
    _, batched = make_multi_job(k_max)
    J, K_max = cfg.active.shape
    gs = torch.from_numpy(np.random.default_rng(7).gumbel(size=(J, K_max)).astype(np.float32))
    state, out = batched(cfg, multi_job_init(cfg), gs, torch.ones((J, K_max)))
    idx, p, mask = out["idx"].numpy(), out["p"].numpy(), out["mask"].numpy()
    for j in range(J):
        sel = idx[j][idx[j] >= 0]
        assert len(sel) == ks[j] and (sel < Ks[j]).all() and len(set(sel.tolist())) == ks[j]
        assert p[j, Ks[j]:].sum() == 0.0 and abs(p[j].sum() - ks[j]) < 1e-3
        assert mask[j].sum() == ks[j]
        assert p[j, :Ks[j]].min() >= float(cfg.sigma[j]) - 1e-6
        assert state.logw.numpy()[j, Ks[j]:].sum() == 0.0


def test_fleet_learns_stable_clients():
    """With the paper's four volatility classes, E3CS mass concentrates on
    the 0.9 class in every job of the batch."""
    Ks, ks = [40, 80], [8, 16]
    cfg, k_max = pack_jobs(Ks, ks, [0.0, 0.0], [0.5, 0.5], device="cpu")
    _, batched = make_multi_job(k_max)
    state = multi_job_init(cfg)
    J, K_max = cfg.active.shape
    rng = np.random.default_rng(3)
    rhos = np.stack([np.pad(paper_success_rates(Kj), (0, K_max - Kj)) for Kj in Ks])
    np.testing.assert_array_equal(rhos[0, :40], jpaper_success_rates(40))
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros((J, K_max))
    for _ in range(300):
        gs = -torch.log(-torch.log(torch.rand((J, K_max), generator=gen).clamp(min=1e-38)))
        xs = torch.from_numpy((rng.random((J, K_max)) < rhos).astype(np.float32))
        state, out = batched(cfg, state, gs, xs)
        counts += out["mask"].numpy()
    for j in range(J):
        per_class = counts[j, :Ks[j]].reshape(4, -1).sum(1)
        assert per_class[3] > 2 * per_class[0], per_class


def test_an_admitted_slot_selects_from_its_population():
    """A config from ``slot_admit`` is data for the same step: the slot's
    cohort is its new k clients among its new K, and a retired slot drops
    out of every update."""
    cfg, k_max = pack_jobs(*MIX, device="cpu")
    _, batched = make_multi_job(k_max)
    state = multi_job_init(cfg)
    J, K_max = cfg.active.shape
    cfg = slot_retire(slot_admit(cfg, 2, 30, 6, 0.5, 0.5), 0)
    gs = torch.from_numpy(np.random.default_rng(8).gumbel(size=(J, K_max)).astype(np.float32))
    state, out = batched(cfg, state, gs, torch.ones((J, K_max)))
    sel = out["idx"][2][out["idx"][2] >= 0]
    assert len(sel) == 6 and int(sel.max()) < 30 and float(out["p"][2, 30:].sum()) == 0.0
    assert float(state.logw[2, 30:].abs().sum()) == 0.0

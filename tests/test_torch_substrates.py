"""The port's optimizers, schedules and data pipeline against the JAX
package's, on the same arrays made with numpy from a seed.

The optimizers and schedules are elementwise float32 operations in the same
order in both packages; XLA may contract a multiply and an add into one
fused operation where ATen rounds twice, so parameters and states are held
to ``RTOL`` (a few ulps), schedules to ``SCHED_RTOL``.  The data modules are
numpy copies: datasets, partitions and every ``ClientStore.round_batches``
call of a sequence are equal byte for byte.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import optim as joptim
from repro_torch import data as tdata
from repro_torch import optim as toptim

RTOL, ATOL = 1e-6, 1e-7
SCHED_RTOL = 1e-6


def _tree(seed, lead=()):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=lead + (4, 3)).astype(np.float32), "b": rng.normal(size=lead + (3,)).astype(np.float32)}


def _assert_tree(got, want):
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=RTOL, atol=ATOL)


OPTS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_momentum": lambda m: m.sgd(0.1, 0.9),
    "sgd_nesterov": lambda m: m.sgd(0.05, 0.9, nesterov=True),
    "sgd_weight_decay": lambda m: m.sgd(0.05, 0.9, weight_decay=0.01),
    "sgd_schedule": lambda m: m.sgd(m.cosine_decay(0.1, 10), 0.9),
    "adamw": lambda m: m.adamw(0.01),
    "adamw_param_dtype_state": lambda m: m.adamw(0.01, fp32_state=False),
}


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_matches_jax_over_steps(name):
    jopt, opt = OPTS[name](joptim), OPTS[name](toptim)
    p0 = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, s = jopt.init(jp), opt.init(p)
    for step in range(8):
        g = _tree(100 + step)
        jp, js = jopt.update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, step)
        p, s = opt.update(p, {k: torch.from_numpy(v) for k, v in g.items()}, s, step)
        _assert_tree(p, jp)
    if name.startswith("adamw"):
        _assert_tree(s.mu, js.mu)
        _assert_tree(s.nu, js.nu)
    elif s != ():
        _assert_tree(s, js)


def test_sgd_momentum_closed_form():
    """``tests/test_substrates.py``'s hand case: m = 1, p = 0.9; m = 1.9, p = 0.71."""
    opt = toptim.sgd(0.1, 0.9)
    p = {"w": torch.tensor([1.0])}
    s = opt.init(p)
    g = {"w": torch.tensor([1.0])}
    p, s = opt.update(p, g, s, 0)
    np.testing.assert_allclose(p["w"].numpy(), [0.9])
    p, s = opt.update(p, g, s, 1)
    np.testing.assert_allclose(p["w"].numpy(), [0.71], rtol=1e-6)


def test_stacked_update_equals_each_row():
    """The FL cohort updates ``(k, ...)`` stacks: each row bit for bit the
    update of that row alone."""
    opt = toptim.sgd(0.05, 0.9, nesterov=True, weight_decay=0.01)
    p, g = _tree(1, (3,)), _tree(2, (3,))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    new, st = opt.update(tp, tg, opt.init(tp), 0)
    for r in range(3):
        rp = {k: v[r] for k, v in tp.items()}
        one, ost = opt.update(rp, {k: v[r] for k, v in tg.items()}, opt.init(rp), 0)
        for k in one:
            assert torch.equal(one[k], new[k][r]) and torch.equal(ost[k], st[k][r])


@pytest.mark.parametrize("sched", ["constant", "cosine_decay", "warmup_cosine"])
def test_schedules_match_jax(sched):
    make = {
        "constant": lambda m: m.constant(0.3),
        "cosine_decay": lambda m: m.cosine_decay(1.0, 100),
        "warmup_cosine": lambda m: m.warmup_cosine(1.0, 10, 110),
    }[sched]
    jf, f = make(joptim), make(toptim)
    for step in (0, 1, 5, 10, 37, 99, 100, 110, 150):
        got = f(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jf(step)), rtol=SCHED_RTOL, atol=1e-9)


def test_image_dataset_and_partitions_equal_jax():
    shape = (8, 8, 1)
    a, b = tdata.make_image_dataset(10, shape, 2000, 300, seed=3), jdata.make_image_dataset(10, shape, 2000, 300, seed=3)
    for key in ("x", "y", "x_test", "y_test"):
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])
    y = a["y"]
    cases = [
        (tdata.partition_iid(y, 20, 50, seed=1), jdata.partition_iid(y, 20, 50, seed=1)),
        (tdata.partition_primary_label(y, 20, 50, seed=1), jdata.partition_primary_label(y, 20, 50, seed=1)),
        (tdata.partition_dirichlet(y, 20, 50, alpha=0.3, seed=1), jdata.partition_dirichlet(y, 20, 50, alpha=0.3, seed=1)),
    ]
    for got, want in cases:
        assert len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))
    tr, te = tdata.split_local_test(cases[1][0], seed=2)
    jtr, jte = jdata.split_local_test(cases[1][1], seed=2)
    assert all(np.array_equal(g, w) for g, w in zip(tr + te, jtr + jte))


def test_round_batches_sequence_equals_jax():
    """Two stores seeded alike serve the same bytes call after call (the
    FL server's cohort and candidate gathers share the store's stream)."""
    d = jdata.make_image_dataset(26, (28, 28, 1), 1500, 100, seed=0)
    idxs = jdata.partition_primary_label(d["y"], 20, 60, seed=0)
    store, jstore = tdata.ClientStore(d, idxs, seed=4), jdata.ClientStore(d, idxs, seed=4)
    epochs = np.random.default_rng(0).choice((1, 2, 3), 20).astype(np.int32)
    calls = [([0, 3, 5, 7], epochs, 20, 9), ([19, 2], epochs, 20, 0), (list(range(20)), np.ones(20, np.int32), 20, 0)]
    for sel, ep, B, n in calls * 2:
        for got, want in zip(store.round_batches(sel, ep, B, n), jstore.round_batches(sel, ep, B, n)):
            assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()
    assert np.array_equal(store.sizes(), jstore.sizes())
    for got, want in zip(store.eval_batch(50), jstore.eval_batch(50)):
        assert np.array_equal(got, want)


def test_lm_streams_equal_jax():
    s, js = tdata.make_lm_dataset(64, 3000, seed=1), jdata.make_lm_dataset(64, 3000, seed=1)
    assert np.array_equal(s, js)
    np.testing.assert_array_equal(tdata.lm_client_batches(s, 8, [1, 5], 3, 2, 16, seed=2),
                                  jdata.lm_client_batches(js, 8, [1, 5], 3, 2, 16, seed=2))

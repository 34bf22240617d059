"""The port's fairness metrics and regret against the JAX package's.

Fairness runs on tensors in float32 as JAX does.  Counts are integers below
2**24, so their sums are exact in any order, and Jain's index and the top
share equal JAX's within ``RTOL``.  The Gini coefficient sums ranks times
counts, which passes 2**24 (4096 clients of 7 selections: 5.9e7) and then
rounds in each framework's summation order; the result is a difference of
two terms near 1, so the rounding shows as an absolute error, 1.6e-5 for
even counts (the exact answer, 0, is the port's): ``ATOL_GINI``.  Entropy takes a ``log`` per client (XLA's and
PyTorch's may differ by an ulp) and sums them in another order: ``RTOL_LOG``.
Regret is numpy in both packages: equal exactly.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fairness as jf
from repro_torch.core import fairness as tf

jr = importlib.import_module("repro.core.selection.regret")  # the packages export a function of that name
tr = importlib.import_module("repro_torch.core.selection.regret")
RTOL = 1e-6
RTOL_LOG = 1e-5
ATOL_GINI = 1e-4  # about K * float32 eps at 4096 clients


def _counts(kind, K=4096):
    rng = np.random.default_rng({"even": 0, "skewed": 1, "sparse": 2, "one": 3}[kind])
    if kind == "even":
        return np.full(K, 7.0, np.float32)
    if kind == "skewed":
        return rng.zipf(1.6, K).clip(max=5000).astype(np.float32)
    if kind == "sparse":
        return (rng.random(K) < 0.05).astype(np.float32) * rng.integers(1, 50, K)
    c = np.zeros(K, np.float32)
    c[17] = 40.0
    return c


KINDS = ["even", "skewed", "sparse", "one"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("metric", ["jain_index", "gini", "top_share"])
def test_count_metrics_equal_jax(metric, kind):
    c = _counts(kind)
    got = float(getattr(tf, metric)(torch.from_numpy(c)))
    want = float(getattr(jf, metric)(jnp.asarray(c)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_GINI if metric == "gini" else 1e-7)


@pytest.mark.parametrize("kind", KINDS)
def test_selection_entropy_equals_jax(kind):
    c = _counts(kind)
    np.testing.assert_allclose(float(tf.selection_entropy(torch.from_numpy(c))),
                               float(jf.selection_entropy(jnp.asarray(c))), rtol=RTOL_LOG, atol=1e-7)


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.25, 1 / 3])
def test_top_share_fractions_equal_jax(frac):
    c = _counts("skewed")
    np.testing.assert_allclose(float(tf.top_share(torch.from_numpy(c), frac)), float(jf.top_share(jnp.asarray(c), frac)),
                               rtol=RTOL)


@pytest.mark.parametrize("p_on", [0.0, 0.3, 0.9])
def test_cep_and_success_ratio_equal_jax(p_on):
    rng = np.random.default_rng(4)
    T, K = 30, 1024
    masks = np.zeros((T, K), np.float32)
    for t in range(T):
        masks[t, rng.permutation(K)[:32]] = 1.0
    xs = (rng.random((T, K)) < p_on).astype(np.float32)
    assert float(tf.cep(torch.from_numpy(masks), torch.from_numpy(xs))) == float(jf.cep(masks, xs))
    np.testing.assert_allclose(float(tf.success_ratio(torch.from_numpy(masks), torch.from_numpy(xs))),
                               float(jf.success_ratio(jnp.asarray(masks), jnp.asarray(xs))), rtol=RTOL)


def test_class_selection_stats_equal_jax():
    c = _counts("skewed")
    sizes = [1024, 1024, 1024, 1024]
    assert tf.class_selection_stats(torch.from_numpy(c), sizes) == jf.class_selection_stats(c, sizes)


def _regret_inputs(T=40, K=64, k=8, seed=0):
    rng = np.random.default_rng(seed)
    xs = (rng.random((T, K)) < rng.uniform(0.1, 0.9, K)).astype(np.float32)
    sig = np.linspace(0.0, 0.5 * k / K, T).astype(np.float32)
    ps = rng.dirichlet(np.ones(K), T).astype(np.float32) * k
    return xs, k, sig, np.minimum(ps, 1.0)


@pytest.mark.parametrize("mode", ["static", "per_round"])
@pytest.mark.parametrize("seed", [0, 1])
def test_regret_equals_jax(mode, seed):
    xs, k, sig, ps = _regret_inputs(seed=seed)
    assert tr.oracle_cep(xs, k, sig, mode) == jr.oracle_cep(xs, k, sig, mode)
    assert tr.empirical_expected_cep(ps, xs) == jr.empirical_expected_cep(ps, xs)
    assert tr.regret(ps, xs, k, sig, mode) == jr.regret(ps, xs, k, sig, mode)


def test_oracle_rejects_an_unknown_mode():
    xs, k, sig, _ = _regret_inputs()
    with pytest.raises(ValueError):
        tr.oracle_cep(xs, k, sig, "dynamic")

"""``FLServer`` on the JAX package's keys: ``init_state(PRNGKey(0))`` and
``run``'s own schedule (``PRNGKey(seed + 1)``, ``split(key, 4)`` a round),
with no draws handed in, against JAX's ``FLServer`` at K = 20, k = 4 for
three rounds: E3CS and pow-d, sync and S = 2.

What is exact.  Cohorts (every round's), ``sel_counts``, ``cep``,
``succ_hist`` and ``n_late``: the selection noise, the volatility rows and
pow-d's candidates come from the same keys, and the initial parameters agree
to a few ulps (``normal``'s bound).  pow-d selects on losses: its cohorts
are held where every round's k-th and (k+1)-th candidate losses lie further
apart than twice the largest difference between the two packages' candidate
losses, which the test measures.  What is not.  The initial parameters are within
``PARAM_ULPS`` float32 ulps of JAX's (``prng.normal``'s 3, and one more for
the scale's product); trained parameters
within the FL tests' ``PARAM_RTOL`` / ``PARAM_ATOL`` (convolutions summed in
another order than XLA's, ``tests/test_torch_fl.py``).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFLConfig, get_config as jget_config
from repro.data import ClientStore as JClientStore, make_image_dataset, partition_primary_label
from repro.fl import FLServer as JFLServer
from repro.models import build_model as jbuild_model
from repro_torch.configs import FLConfig, get_config
from repro_torch.convert import cnn_params_to_numpy
from repro_torch.core import prng
from repro_torch.data import ClientStore
from repro_torch.fl import FLServer
from repro_torch.models import build_model

K, k, ROUNDS = 20, 4, 3
NORMAL_ULPS = 3
PARAM_ULPS = NORMAL_ULPS + 1  # a normal within 3 ulps, times a float32 scale and rounded
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-4


def _jax_report(self, state, rng):
    """JAX's pow-d candidate stage with its cache copied before the write:
    under jax 0.9 ``np.asarray`` of a device array is read-only and the
    reference's own ``cache[cand] = ...`` raises (ROADMAP §C)."""
    cand = np.asarray(jax.random.permutation(rng, self.cfg.K))[: self.cfg.pow_d]
    xb, yb, _ = self.store.round_batches(cand, np.ones(self.cfg.K, np.int32), self.cfg.batch_size)
    losses = self._cand_loss(state.params, {"x": jnp.asarray(xb[:, 0]), "y": jnp.asarray(yb[:, 0])})
    cache = np.array(state.loss_cache)
    cache[cand] = np.asarray(losses)
    self.cand_losses.append((cand, cache))
    return state._replace(loss_cache=jnp.asarray(cache))


def _recording(select, out):
    def wrapped(state, rng):
        res = select(state, rng)
        out.append(np.asarray(res[0]) if not torch.is_tensor(res[0]) else res[0].numpy())
        return res

    return wrapped


@pytest.fixture(scope="module")
def data():
    d = make_image_dataset(26, (28, 28, 1), 300, 100, seed=0)
    return d, partition_primary_label(d["y"], K, 20, seed=0)


@pytest.mark.parametrize("scheme,S", [("e3cs", 0), ("e3cs", 2), ("pow_d", 0), ("pow_d", 2)])
def test_server_on_jax_keys_equals_jax(data, scheme, S):
    d, idxs = data
    kw = dict(K=K, k=k, rounds=ROUNDS, scheme=scheme, quota="const", quota_frac=0.5, samples_per_client=20,
              batch_size=10, local_epochs=(1,), staleness_rounds=S, late_prob=0.9)
    jsrv = JFLServer(jbuild_model(jget_config("emnist-cnn")), JFLConfig(**kw), JClientStore(d, idxs))
    jsrv.cand_losses = []
    jsrv._report_candidate_losses = types.MethodType(_jax_report, jsrv)
    jidx, pidx = [], []
    jsrv._select = _recording(jsrv._select, jidx)
    js0 = jsrv.init_state(jax.random.PRNGKey(0))
    js, jh = jsrv.run(js0)

    srv = FLServer(build_model(get_config("emnist-cnn")), FLConfig(**kw), ClientStore(d, idxs), device="cpu")
    srv._select = _recording(srv._select, pidx)
    caches, report = [], srv._report_candidate_losses
    srv._report_candidate_losses = lambda state, perm: (lambda out: (caches.append(out.loss_cache.numpy()), out)[1])(
        report(state, perm))
    st0 = srv.init_state(prng.PRNGKey(0, "cpu"))
    got0 = cnn_params_to_numpy(st0.params)
    for name, v in js0.params.items():
        want = np.asarray(v)
        assert np.abs(got0[name].view(np.int32).astype(np.int64) - want.view(np.int32)).max() <= PARAM_ULPS, name
    st, h = srv.run(st0)

    if scheme == "pow_d":  # the k-th candidate loss clear of the next by more than the packages part
        for (cand, jcache), cache in zip(jsrv.cand_losses, caches):
            ordered = np.sort(jcache[cand])[::-1]
            assert ordered[k - 1] - ordered[k] > 2 * np.abs(cache[cand] - jcache[cand]).max()
    assert len(pidx) == len(jidx) == ROUNDS
    for a, b in zip(pidx, jidx):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(st.sel_counts.numpy(), np.asarray(js.sel_counts))
    assert float(st.cep) == float(js.cep) and float(st.succ_hist) == float(js.succ_hist)
    if S:
        assert h["n_late"] == jh["n_late"]
    got = cnn_params_to_numpy(st.params)
    for name, v in js.params.items():
        np.testing.assert_allclose(got[name], np.asarray(v), rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)

"""pow-d on a mesh: the port's ``FLServer(spmd_axes="data", scheme="pow_d")``
against JAX's ``FLServer(spmd_axes="data")`` over a ``(data,)`` mesh of two
host devices, the EMNIST CNN given JAX's initial parameters and JAX's draws,
on a one-rank and a two-rank gloo mesh (spawned, ``torch_mesh_zoo_ranks``,
no JAX).  JAX's candidate stage runs with its one write on a copy
(``test_torch_fl._fixed_report``, ROADMAP §C).

Cohorts and selection counts are exact (the rounds' k-th and (k+1)-th
candidate losses are further apart than ``LOSS_GAP``, which the test
asserts); the loss cache within ``GRAD_TOL``; the trained parameters within
``test_torch_fl``'s tolerances (convolutions summed in another order).
"""
import pickle
import types

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.data import ClientStore as JClientStore
from repro.fl import FLServer as JFLServer
from repro.models import build_model as jbuild_model
from test_torch_fl import LOSS_GAP, PARAM_ATOL, PARAM_RTOL, _data, _fixed_report, _fl, _np_tree, _server_noise
from torch_mesh_zoo_ranks import join_groups, pow_d_server_rank, start_groups
from torch_zoo_common import GRAD_TOL

TIMEOUT = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jfl, fl = _fl(scheme="pow_d")
    d, idxs = _data()
    jm = jbuild_model(jget_config("emnist-cnn"))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    rounds = [{"perm": n.perm.numpy(), "u": n.u[0].numpy(), "cand": c.numpy()} for n, c in _server_noise(fl, fl.rounds)]
    inputs = {"data": {n: np.asarray(v) for n, v in d.items()}, "idxs": idxs, "params": _np_tree(jp),
              "rounds": rounds}
    kw = {f.name: getattr(fl, f.name) for f in type(fl).__dataclass_fields__.values()}
    base = tmp_path_factory.mktemp("pow_d_mesh")
    with open(base / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    groups = start_groups([(pow_d_server_rank, D, base / f"d{D}", D, kw, str(base / "inputs.pkl")) for D in (1, 2)])
    jsrv = JFLServer(jm, jfl, JClientStore(d, idxs), spmd_axes="data")
    jsrv.cand_losses, jidx = [], []
    jsrv._report_candidate_losses = types.MethodType(_fixed_report, jsrv)
    jselect = jsrv._select
    jsrv._select = lambda s, r: (lambda out: (jidx.append(np.asarray(out[0])), out)[1])(jselect(s, r))
    with jax.set_mesh(jax.make_mesh((2,), ("data",), devices=jax.devices()[:2])):
        js, _ = jsrv.run(jsrv.init_state(jax.random.PRNGKey(0)))
    return {"ranks": join_groups(groups, TIMEOUT), "jax": js, "jidx": np.stack(jidx), "cand": jsrv.cand_losses,
            "k": fl.k}


@pytest.mark.parametrize("which", [0, 1], ids=["d1", "d2"])
def test_pow_d_server_on_a_mesh_matches_jax(runs, which):
    gaps = [c[runs["k"] - 1] - c[runs["k"]] for c in runs["cand"]]
    assert min(gaps) > LOSS_GAP, gaps
    js = runs["jax"]
    for got in runs["ranks"][which]:
        np.testing.assert_array_equal(got["cohorts"], runs["jidx"])
        np.testing.assert_array_equal(got["sel_counts"], np.asarray(js.sel_counts))
        assert float(got["cep"]) == float(js.cep)
        np.testing.assert_allclose(got["loss_cache"], np.asarray(js.loss_cache), **GRAD_TOL)
        for name, v in _np_tree(js.params).items():
            np.testing.assert_allclose(got[f"params/{name}"], v, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)

"""Federated training of a zoo LM on a mesh in the port, against the JAX
package unsharded, on spawned gloo ranks (``torch_mesh_zoo_ranks``, no JAX):

* ``make_cohort_round(spmd_axes="data")`` over the gemma smoke, given JAX's
  draws, two rounds, on ``(data, model) = (2, 2)`` (each data rank trains
  its 4 of the 8 clients one after another on DTensor parameters sharded
  over ``model``) and ``(2, 1)`` (its clients vectorised on local tensors);
* ``make_silo_steps`` under ``silo_rules`` (FSDP over ``data``, TP over
  ``model``) over the qwen3-moe smoke, two clients of two steps, at (2, 2).

What is exact: cohorts, masks, selection counts and successes, and every
rank's outputs against every other's.  Log-weights to the allocator's ulps
(``LOGW_ATOL``).  Losses and parameters within ``GRAD_TOL``.
"""
import numpy as np
import pytest

from torch_mesh_zoo_common import FL_KW, LOGW_ATOL, SILO_KW, TIMEOUT, _cohort_inputs, _keyed, _same_on_every_rank, \
    _silo_inputs
from torch_mesh_zoo_ranks import cohort_round_rank, join_groups, silo_rank, start_groups
from torch_zoo_common import GRAD_TOL


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_fl")
    cohort_in, cohort_ref = _cohort_inputs()
    silo_in, silo_ref = _silo_inputs()
    groups = start_groups([(cohort_round_rank, 4, base / "cohort4", (2, 2), "gemma-2b", FL_KW, cohort_in),
                           (cohort_round_rank, 2, base / "cohort2", (2, 1), "gemma-2b", FL_KW, cohort_in),
                           (silo_rank, 4, base / "silo4", (2, 2), "qwen3-moe-30b-a3b", SILO_KW, silo_in)])
    res = join_groups(groups, TIMEOUT)
    return {"cohort": res[:2], "cohort_ref": cohort_ref, "silo": res[2], "silo_ref": silo_ref}


@pytest.mark.parametrize("which", [0, 1], ids=["2x2", "2x1"])
def test_cohort_round_over_the_data_axis_matches_jax(runs, which):
    ranks = runs["cohort"][which]
    _same_on_every_rank(ranks)
    got = ranks[0]
    for t, ref in enumerate(runs["cohort_ref"]):
        np.testing.assert_array_equal(got[f"{t}/idx"], ref["idx"])
        np.testing.assert_array_equal(got[f"{t}/sel_counts"], ref["sel_counts"])
        assert float(got[f"{t}/n_success"]) == ref["n_success"]
        np.testing.assert_allclose(got[f"{t}/logw"], ref["logw"], rtol=1e-6, atol=LOGW_ATOL)
        np.testing.assert_allclose(float(got[f"{t}/loss"]), ref["loss"], **GRAD_TOL)
        for k, v in _keyed(f"{t}/params", ref["params"]).items():
            np.testing.assert_allclose(got[k], v, **GRAD_TOL, err_msg=k)


def test_silo_steps_under_fsdp_and_tp_match_jax(runs):
    ranks, ref = runs["silo"], runs["silo_ref"]
    _same_on_every_rank(ranks)
    got = ranks[0]
    losses = [float(got[f"{c}/{i}/loss"]) for c in range(2) for i in range(2)]
    np.testing.assert_allclose(losses, ref["losses"], **GRAD_TOL)
    for c, jq in enumerate(ref["params"]):
        for k, v in _keyed(f"{c}/params", jq).items():
            np.testing.assert_allclose(got[k], v, **GRAD_TOL, err_msg=k)
    for k, v in _keyed("new", ref["new"]).items():
        np.testing.assert_allclose(got[k], v, **GRAD_TOL, err_msg=k)

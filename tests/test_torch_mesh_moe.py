"""The MoE layer on a mesh in the port, against the JAX package's
``moe_apply`` on one device, at a capacity that drops choices.

Spawned gloo ranks (``torch_mesh_zoo_ranks.moe_rank``, which imports no
JAX) place the deepseek smoke's MoE parameters (its shared expert too) and
a batch as DTensors on ``(data, model) = (2, 2)`` and ``(2, 1)`` under
``cohort_rules`` and ``silo_rules``, and run both dispatches (einsum and
scatter) at ``capacity_factor=1``: each rank routes its own rows with the
whole batch's capacities and queue positions, so the same choices drop as
on one device.  Held against JAX: the output, the balance loss and the
gradients of ``sum(y * r) + aux`` for ``x`` and every parameter, float32
sums split over ranks, within ``GRAD_TOL``; every rank returns the same.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config, smoke_variant as jsmoke_variant
from repro.models.moe import moe_apply as jmoe_apply
from torch_mesh_zoo_common import _same_on_every_rank
from torch_mesh_zoo_ranks import join_groups, moe_rank, start_groups
from torch_zoo_common import GRAD_TOL

ARCH = "deepseek-v3-671b"
MESHES = {4: (2, 2), 2: (2, 1)}
CASES = {impl: dict(capacity_factor=1.0, moe_impl=impl) for impl in ("einsum", "scatter")}
B, S = 4, 8
TIMEOUT = 240


def _inputs():
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.layers import ParamBuilder
    from repro_torch.models.moe import moe_init

    pb = ParamBuilder(None, device="meta")
    moe_init(pb, smoke_variant(get_config(ARCH)))
    rng = np.random.default_rng(0)
    fan_in = {"router": 0, "w_in": 1, "w_out": 1, "w_in_shared": 0, "w_out_shared": 0}  # moe_init's
    params = {k: (rng.standard_normal(tuple(t.shape)) / np.sqrt(t.shape[fan_in[k]])).astype(np.float32)
              for k, t in pb.params.items()}
    d = pb.params["router"].shape[0]
    return {"params": params, "x": rng.standard_normal((B, S, d)).astype(np.float32),
            "r": rng.standard_normal((B, S, d)).astype(np.float32)}


def _jax_ref(inputs, over):
    cfg = dataclasses.replace(jsmoke_variant(jget_config(ARCH)), **over)

    def f(x, p):
        y, aux = jmoe_apply(p, x, cfg)
        return jnp.sum(y * inputs["r"]) + aux, (y, aux)

    p = {k: jnp.asarray(v) for k, v in inputs["params"].items()}
    (_, (y, aux)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(jnp.asarray(inputs["x"]), p)
    # the case must drop choices: some expert's load is past its capacity
    probs = jax.nn.softmax(inputs["x"].reshape(-1, cfg.d_model) @ inputs["params"]["router"], axis=-1)
    top = np.argsort(-np.asarray(probs), axis=-1, kind="stable")[:, :cfg.moe_top_k]
    C = max(1, int(B * S * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor))
    assert np.bincount(top.ravel(), minlength=cfg.n_experts).max() > C
    return {"y": np.asarray(y), "aux": np.asarray(aux), "grad/x": np.asarray(gx),
            **{f"grad/{k}": np.asarray(v) for k, v in gp.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_moe")
    inputs = _inputs()
    groups = start_groups([(moe_rank, D, base / f"moe{D}", MESHES[D], ARCH, CASES, inputs) for D in MESHES])
    refs = {case: _jax_ref(inputs, over) for case, over in CASES.items()}
    return dict(zip(MESHES, join_groups(groups, TIMEOUT))), refs


@pytest.mark.parametrize("D", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rules", ["cohort", "silo"])
def test_moe_on_a_mesh_drops_as_jax_does(runs, D, case, rules):
    got, refs = runs[0][D][0], runs[1][case]
    for k, v in refs.items():
        np.testing.assert_allclose(got[f"{case}/{rules}/{k}"], v, **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("D", sorted(MESHES))
def test_moe_every_rank_returns_the_same(runs, D):
    _same_on_every_rank(runs[0][D])

"""The model zoo's training gradients, MoE archs (qwen3-moe, deepseek-v3
with MLA and MTP): loss, router aux and every gradient leaf against
``jax.value_and_grad``, one SGD step against JAX's, with ``remat=True`` in
both configs (``torch_zoo_common.GRAD_TOL``); and the MoE vectorised over
clients (``torch.func.vmap`` of ``grad_and_value``, as the FL cohort's local
update runs it) against a loop over them, with both dispatches."""
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap
from torch.utils import _pytree as pytree

from repro_torch.models import build_model
from torch_zoo_common import GRAD_TOL, check_train, configs, np_batch, tc

ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v3-671b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    check_train(arch, "grads")


@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_step_matches_jax(arch):
    check_train(arch, "sgd")


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_moe_vmapped_gradients_equal_a_loop(impl):
    """The qwen3-moe smoke at ``capacity_factor=1.25`` (tokens drop): the loss
    and gradients of three clients' batches at once, from shared and from
    stacked parameters, against one client at a time.  Routing is exact in
    both; the batched matmuls sum in other blocks than one client's
    (``GRAD_TOL``)."""
    _, cfg = configs("qwen3-moe-30b-a3b", remat=True, moe_impl=impl, capacity_factor=1.25)
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0))[0]
    batches = [tc(np_batch(cfg, seed=s)) for s in range(3)]
    stacked_b = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    stacked_p = pytree.tree_map(lambda t: torch.stack([t, t * 0.5, t * 2.0]), p)
    fn = grad_and_value(lambda q, b: m.loss(q, b)[0])
    for params, in_dims in ((p, (None, 0)), (stacked_p, (0, 0))):
        g, l = vmap(fn, in_dims=in_dims)(params, stacked_b)
        for c, b in enumerate(batches):
            pc = params if in_dims[0] is None else pytree.tree_map(lambda t: t[c], params)
            gc, lc = fn(pc, b)
            np.testing.assert_allclose(float(l[c]), float(lc), **GRAD_TOL)
            for a, want in zip(pytree.tree_leaves(g), pytree.tree_leaves(gc)):
                np.testing.assert_allclose(a[c].numpy(), want.numpy(), **GRAD_TOL)

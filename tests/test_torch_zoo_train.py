"""The model zoo's training gradients, dense and VLM archs:
each ``loss`` and its gradients in the port against ``jax.value_and_grad``
of the JAX package's, with ``remat=True`` in both packages' configs, from
the same parameters (``lm_params_from_jax``) and batch; one SGD step; gemma
in bf16; and, for all ten archs, the port's remat against none, bit for
bit.  The MoE archs are in ``test_torch_zoo_train_moe.py``, the SSM,
hybrid and encoder-decoder ones in ``test_torch_zoo_train_ssm.py``.

Tolerance (``torch_zoo_common.GRAD_TOL``, rtol 1e-4, atol 2e-5): XLA and
ATen sum the same float32 products in other orders, and a gradient sums
over every token of the batch.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.func import grad_and_value
from torch.utils import _pytree as pytree

from repro_torch.configs import ASSIGNED
from repro_torch.models import build_model
from torch_zoo_common import BF16_TOL, check_train, configs, np_batch, tc, train_both

ARCHS = ["stablelm-1.6b", "llama3-405b", "qwen2-vl-72b", "gemma-2b", "nemotron-4-15b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    check_train(arch, "grads")


@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_step_matches_jax(arch):
    """``tests/test_models.py::test_smoke_forward_and_train_step`` on the
    port: one ``sgd(1e-2, 0.9)`` step, the new parameters and the loss there
    against JAX's."""
    check_train(arch, "sgd")


def test_gemma_bf16_matches_jax():
    """bfloat16 end to end: loss, gradients and the stepped parameters within
    the zoo tests' bf16 bound (``BF16_TOL``: a few 8-bit roundings at the
    values' scale)."""
    out = train_both("gemma-2b", "bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in pytree.tree_leaves(out["port"]["grads"]))
    check_train("gemma-2b", "grads", "bfloat16", BF16_TOL)
    check_train("gemma-2b", "sgd", "bfloat16", BF16_TOL)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_remat_equals_no_remat_bit_for_bit(arch):
    """The rematerialised layers recompute the same operations on the same
    inputs: the loss and every gradient leaf equal the plain graph's
    exactly, under ``torch.func.grad`` and under plain autograd."""
    _, cfg = configs(arch)
    p = build_model(cfg).init(torch.Generator().manual_seed(0))[0]
    batch = tc(np_batch(cfg))
    out = {}
    for remat in (False, True):
        m = build_model(dataclasses.replace(cfg, remat=remat))
        g, (l, _) = grad_and_value(m.loss, has_aux=True)(p, batch)
        leaves, spec = pytree.tree_flatten(p)
        diff = [t.detach().requires_grad_() for t in leaves]
        la, _ = m.loss(pytree.tree_unflatten(diff, spec), batch)
        out[remat] = [l, la, *pytree.tree_leaves(g), *torch.autograd.grad(la, diff)]
    assert len(out[True]) == len(out[False])
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)
    # under no gradient the rematerialised model is the plain forward
    with torch.no_grad():
        a, b = (build_model(dataclasses.replace(cfg, remat=r)).forward(p, batch) for r in (False, True))
    assert torch.equal(a, b) and np.isfinite(a.numpy()).all()

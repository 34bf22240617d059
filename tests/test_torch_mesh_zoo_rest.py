"""The model zoo on a mesh in the port, against the JAX package unsharded:
the SSM (mamba2), the hybrid (zamba2) and the enc-dec (whisper).

Spawned gloo ranks (``torch_mesh_zoo_ranks``, which imports no JAX) place
JAX's smoke parameters as DTensors on a ``DeviceMesh`` of D = 4 ranks as
``(data, model) = (2, 2)`` and of D = 2 as ``(1, 2)`` and run the loss and
its gradients under ``cohort_rules`` and ``silo_rules``, then a prefill and
three greedy decode steps under the dry run's ``serve_rules`` (decode with
``cache_seq`` over ``model`` where the KV heads do not divide).

What is exact: the greedy tokens, and every rank's outputs against every
other's.  What is not: losses, gradients and logits are float32 sums that
the mesh splits over ranks (partial sums all-reduced) and XLA orders
otherwise, within ``GRAD_TOL`` / ``F32_TOL`` (``torch_zoo_common``).
"""
import pytest

from torch_mesh_zoo_common import ARCHS_REST, MESHES, _same_on_every_rank, check_loss_and_grads, \
    check_prefill_and_decode, zoo_runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return zoo_runs(tmp_path_factory.mktemp("mesh_zoo"), ARCHS_REST)


@pytest.mark.parametrize("D", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS_REST)
@pytest.mark.parametrize("rules", ["cohort", "silo"])
def test_loss_and_grads_on_a_mesh_match_jax(runs, D, arch, rules):
    check_loss_and_grads(runs, D, arch, rules)


@pytest.mark.parametrize("D", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS_REST)
def test_prefill_and_decode_on_a_mesh_match_jax(runs, D, arch):
    check_prefill_and_decode(runs, D, arch)


@pytest.mark.parametrize("D", sorted(MESHES))
def test_every_rank_returns_the_same(runs, D):
    _same_on_every_rank(runs["zoo"][D])

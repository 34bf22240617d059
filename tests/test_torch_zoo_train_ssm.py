"""The model zoo's training gradients, SSM, hybrid and encoder-decoder archs
(mamba2; zamba2 with its weight-shared attention inside the rematerialised
layer; whisper, encoder and decoder rematerialised): loss and
every gradient leaf against ``jax.value_and_grad``, and one SGD step against
JAX's, with ``remat=True`` in both configs (``torch_zoo_common.GRAD_TOL``)."""
import pytest

from torch_zoo_common import check_train

ARCHS = ["mamba2-130m", "zamba2-7b", "whisper-base"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    check_train(arch, "grads")


@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_step_matches_jax(arch):
    check_train(arch, "sgd")

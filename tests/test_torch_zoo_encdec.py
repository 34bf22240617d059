"""The model zoo's enc-dec arch (stub frames, sinusoidal encoder positions, learned decoder positions, cross attention) end to end at
``smoke_variant`` in float32: the port's ``loss`` (and its metrics),
``forward``, ``prefill`` (logits and every cache leaf) and 3 greedy
``decode`` steps against the JAX package's from JAX's parameters
(``torch_zoo_common.run_both``; tolerance ``F32_TOL``, tokens and cache
positions exact)."""
import pytest

from torch_zoo_common import CHECKS, check, configs, run_both

ARCHS = ["whisper-base",]


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return run_both(*configs(request.param))


@pytest.mark.parametrize("what", CHECKS)
def test_smoke_equals_jax(run, what):
    check(run, what)

"""The model zoo's SSM and hybrid archs (chunked SSD prefill, the O(1) recurrent decode, the shared attention block) end to end at
``smoke_variant`` in float32: the port's ``loss`` (and its metrics),
``forward``, ``prefill`` (logits and every cache leaf) and 3 greedy
``decode`` steps against the JAX package's from JAX's parameters
(``torch_zoo_common.run_both``; tolerance ``F32_TOL``, tokens and cache
positions exact)."""
import pytest

from torch_zoo_common import CHECKS, check, configs, run_both

ARCHS = ["mamba2-130m", "zamba2-7b"]


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return run_both(*configs(request.param))


@pytest.mark.parametrize("what", CHECKS)
def test_smoke_equals_jax(run, what):
    check(run, what)

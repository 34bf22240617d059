"""The model zoo's MoE archs (MLA with a leading dense layer and the MTP head; scatter dispatch) end to end at
``smoke_variant`` in float32: the port's ``loss`` (and its metrics),
``forward``, ``prefill`` (logits and every cache leaf) and 3 greedy
``decode`` steps against the JAX package's from JAX's parameters
(``torch_zoo_common.run_both``; tolerance ``F32_TOL``, tokens and cache
positions exact)."""
import pytest

from torch_zoo_common import BF16_TOL, CHECKS, check, configs, run_both

ARCHS = ["deepseek-v3-671b", "qwen3-moe-30b-a3b"]


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return run_both(*configs(request.param))


@pytest.mark.parametrize("what", CHECKS)
def test_smoke_equals_jax(run, what):
    check(run, what)


@pytest.fixture(scope="module")
def run_bf16():
    return run_both(*configs("qwen3-moe-30b-a3b", dtype="bfloat16"))


@pytest.mark.parametrize("what", CHECKS)
def test_bf16_smoke_equals_jax(run_bf16, what):
    """The smoke qwen3-moe-30b-a3b with bfloat16 parameters and activations, within
    ``BF16_TOL``."""
    check(run_bf16, what, BF16_TOL, tokens=False)

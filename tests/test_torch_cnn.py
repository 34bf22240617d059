"""The paper's CNNs in the port against the JAX package's: the registry,
the parameter builder's law, the weight conversion, and forward, loss and
every gradient at batch 4 from JAX's own initial parameters.

The port computes NCHW convolutions with OIHW kernels where XLA computes
NHWC with HWIO ones; the sums of a convolution are taken in another order
by ATen than by XLA's CPU backend, so logits, losses and gradients are held
to ``RTOL``/``ATOL`` (measured: logits 8e-7 relative, gradients 4e-7
absolute on O(0.1-1) values).  A wrong layout (a kernel or ``fc1``'s flatten
order permuted) misses by O(1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model, cross_entropy as jcross_entropy
from repro_torch.configs import ModelConfig, get_config, list_archs
from repro_torch.convert import cnn_params_from_jax, cnn_params_to_numpy
from repro_torch.models import build_model, cross_entropy
from repro_torch.models.cnn import CNN_SHAPES, PaperCNN, cnn_forward
from repro_torch.models.layers import ParamBuilder

RTOL, ATOL = 1e-5, 2e-6
CNNS = ["emnist-cnn", "cifar-cnn"]


@pytest.mark.parametrize("name", CNNS)
def test_registered_config_equals_jax(name):
    from repro.configs import list_archs as jlist_archs

    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jget_config(name))
    assert list_archs() == jlist_archs() and set(CNNS) <= set(list_archs())
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gemma-3b")


def test_model_config_fields_equal_jax():
    from repro.configs import ModelConfig as JModelConfig

    assert {f.name: f.default for f in dataclasses.fields(ModelConfig)} == \
        {f.name: f.default for f in dataclasses.fields(JModelConfig)}


def test_other_families_name_their_roadmap_item():
    """The model zoo builds every other family (its tests are
    ``test_torch_zoo*.py``); a family neither package knows raises
    ``ValueError`` naming it at ``init``, as the JAX package's does."""
    assert build_model(ModelConfig(name="x", family="dense")).module is None
    for build in (build_model, jbuild_model):
        with pytest.raises(ValueError, match="retnet"):
            build(ModelConfig(name="x", family="retnet")).init(torch.Generator() if build is build_model
                                                                  else jax.random.PRNGKey(0))


def test_param_builder_law():
    """normal at ``1/sqrt(fan_in)`` (or ``scale``), zeros, ones, embed at
    0.02, each drawn in order from the generator; the specs mirror."""
    pb = ParamBuilder(torch.Generator().manual_seed(0))
    w = pb.p("w", (400, 500), ("a", "b"), fan_in=100)
    e = pb.p("e", (300, 400), ("v", "d"), init="embed")
    s = pb.p("s", (200, 300), ("a", "b"), scale=0.5)
    z, o = pb.p("z", (7,), ("a",), init="zeros"), pb.p("o", (7,), ("a",), init="ones")
    for t, std in ((w, 0.1), (e, 0.02), (s, 0.5)):
        assert t.dtype == torch.float32
        assert abs(float(t.mean())) < 4 * std / np.sqrt(t.numel())
        assert abs(float(t.std()) / std - 1) < 0.01
    assert torch.equal(z, torch.zeros(7)) and torch.equal(o, torch.ones(7))
    assert pb.specs == {"w": ("a", "b"), "e": ("v", "d"), "s": ("a", "b"), "z": ("a",), "o": ("a",)}
    again = ParamBuilder(torch.Generator().manual_seed(0)).p("w", (400, 500), ("a", "b"), fan_in=100)
    assert torch.equal(again, w)
    with pytest.raises(ValueError):
        pb.p("bad", (2,), ("a",), init="uniform")


def _jax_params(name, seed=0):
    jm = jbuild_model(jget_config(name))
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    return jm, jp


@pytest.mark.parametrize("name", CNNS)
def test_init_shapes_and_conversion_round_trip(name):
    jm, jp = _jax_params(name)
    m = build_model(get_config(name))
    p, specs = m.init(torch.Generator().manual_seed(0))
    ported = cnn_params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    assert list(p) == list(ported) == list(jp)
    for k in p:
        assert p[k].shape == ported[k].shape and specs[k] == (None,) * p[k].dim()
    back = cnn_params_to_numpy(ported)
    for k in jp:
        assert back[k].dtype == np.float32 and np.array_equal(back[k], np.asarray(jp[k]))
    # a cohort's stacked leaves cross as well
    stacked = {k: np.stack([np.asarray(v)] * 3) for k, v in jp.items()}
    assert all(np.array_equal(a, stacked[k]) for k, a in cnn_params_to_numpy(cnn_params_from_jax(stacked, "cpu")).items())


def _batch(name, seed=1):
    H, W, C = CNN_SHAPES[name]["img"]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, H, W, C)).astype(np.float32)
    y = rng.integers(0, CNN_SHAPES[name]["classes"], 4).astype(np.int32)
    return x, y


@pytest.mark.parametrize("name", CNNS)
def test_forward_loss_and_gradients_match_jax(name):
    jm, jp = _jax_params(name)
    m = build_model(get_config(name))
    p = cnn_params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    x, y = _batch(name)
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    np.testing.assert_allclose(m.forward(p, batch).numpy(), np.asarray(jm.forward(jp, jbatch)), rtol=RTOL, atol=ATOL)
    # the module and the plain function agree with the façade
    module = PaperCNN(get_config(name), {k: v.clone() for k, v in p.items()})
    assert [n for n, _ in module.named_parameters()] == list(jp)
    torch.testing.assert_close(module(batch["x"]), cnn_forward(p, get_config(name), batch), rtol=0, atol=0)
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(jp, jbatch)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    loss, met = m.loss(leaves, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    assert float(met["acc"]) == float(jmet["acc"])
    grads = cnn_params_to_numpy({k: v.grad for k, v in leaves.items()})
    for k in jgrads:
        np.testing.assert_allclose(grads[k], np.asarray(jgrads[k]), rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "masked"])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(3, 5, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.5).astype(np.float32) if masked else None
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), None if mask is None else torch.from_numpy(mask))
    want = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels), None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if masked:  # an all-zero mask divides by max(sum, 1)
        zero = torch.zeros(3, 5)
        assert float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), zero)) == 0.0

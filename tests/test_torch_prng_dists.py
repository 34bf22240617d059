"""The key stream's distributions (``repro_torch.core.prng``: ``normal``,
``randint``, ``categorical``, and ``rows`` / ``split_data`` for J keys at
once) against jax 0.9's ``jax.random``, and the model zoo's initial
parameters drawn from one key against the JAX package's.

Tolerances and their reasons:

* ``randint``, the rows' keys and bits: exact (integer arithmetic).
* ``categorical``: exact.  Its Gumbel noise equals JAX's up to the last bit
  of a ``log``, so only two columns whose scores lie within that bit could
  part; none does on these inputs, and the bfloat16 noise (JAX's 8-bit
  draw, 128 values) equals JAX's exactly.
* ``normal``: within ``NORMAL_ULPS`` float32 ulps of JAX's, over every value
  it can take (the 2**23 uniforms its 23 random bits make): the ``erf_inv``
  polynomial is XLA's with its multiply-adds fused as XLA's CPU backend
  fuses them, but ``log1p`` is ATen's, not XLA's.
* Initial parameters: float32 leaves within ``PARAM_ULPS`` ulps (each is a
  ``normal`` times a float32 scale, one more rounding); bfloat16 leaves within one bfloat16
  ulp (the float32 draws differ by ulps before the cast).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, smoke_variant as jsmoke_variant
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import prng
from repro_torch.kernels import ref
from repro_torch.models import build_model

NORMAL_ULPS = 3
PARAM_ULPS = NORMAL_ULPS + 1  # a normal within 3 ulps, times a float32 scale and rounded
DEV = "cpu"


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_normal_within_its_ulp_bound_over_its_whole_domain():
    """Every uniform ``normal`` can draw (the 2**23 mantissas, mapped as
    ``jax.random.uniform`` maps them onto ``[nextafter(-1, 0), 1)``) through
    the twin's ``sqrt(2) * erf_inv`` and XLA's."""
    f = ((np.arange(2**23, dtype=np.uint32)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo = np.float32(ref.NORMAL_LO)
    u = np.maximum(lo, (f.astype(np.float64) * np.float64(np.float32(1) - lo) + np.float64(lo)).astype(np.float32))
    want = np.asarray(jax.jit(lambda x: np.float32(np.sqrt(2)) * jax.lax.erf_inv(x))(u))
    got = (torch.tensor(np.float32(np.sqrt(2))) * ref.erf_inv_ref(torch.from_numpy(u))).numpy()
    d = _ulps(got, want)
    assert d.max() <= NORMAL_ULPS and (d == 0).mean() > 0.99


@pytest.mark.parametrize("seed,shape", [(0, (4096,)), (7, (33, 65))])
def test_normal_equals_jax_within_ulps(seed, shape):
    got = prng.normal(prng.PRNGKey(seed, DEV), shape)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    assert got.shape == shape and got.dtype == torch.float32
    assert _ulps(got.numpy(), want).max() <= NORMAL_ULPS
    # a block of the same draw, as the parameter builder draws an expert
    flat = got.reshape(-1)
    block = prng.normal(prng.PRNGKey(seed, DEV), (100,), start=1000)
    np.testing.assert_array_equal(block.numpy(), flat[1000:1100].numpy())


@pytest.mark.parametrize("seed,shape,lo,hi,dtype", [
    (0, (1000,), -7, 13, torch.int32),                 # a negative minval, a span of 20
    (1, (40, 25), 0, 256_000, torch.int32),             # gemma's vocabulary: 2**16 % span wraps the multiplier
    (2, (500,), -(2**31), 2**31 - 1, torch.int32),      # the int32 range: the span's top bit set
    (3, (777,), -1000, 1000, torch.int8),               # bounds clamped to int8 before the draw
    (4, (300,), -40_000, 70_000, torch.int16),          # and to int16
    (5, (64,), 9, 9, torch.int32),                      # an empty range returns minval
])
def test_randint_equals_jax_exactly(seed, shape, lo, hi, dtype):
    jdt = {torch.int8: jnp.int8, torch.int16: jnp.int16, torch.int32: jnp.int32}[dtype]
    got = prng.randint(prng.PRNGKey(seed, DEV), shape, lo, hi, dtype)
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi, jdt))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_categorical_equals_jax_with_exact_ties(dtype):
    """Rows of random logits, a row of all-equal logits, a row with two
    tied maxima far above the rest (the noise decides between them) and a
    1-D row."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(5, 3001)).astype(np.float32)
    logits[1] = 0.0
    logits[2, [17, 2900]] = 40.0
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for seed in range(3):
        got = prng.categorical(prng.PRNGKey(seed, DEV), torch.from_numpy(logits).to(dtype))
        want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed), jnp.asarray(logits).astype(jdt)))
        assert got.dtype == torch.int32 and got.shape == (5,)
        np.testing.assert_array_equal(got.numpy(), want)
        one = prng.categorical(prng.fold_in(prng.PRNGKey(seed, DEV), 7), torch.from_numpy(logits[3]).to(dtype))
        np.testing.assert_array_equal(one.numpy(), np.asarray(jax.random.categorical(
            jax.random.fold_in(jax.random.PRNGKey(seed), 7), jnp.asarray(logits[3]).astype(jdt))))
    # exact ties of the scores themselves (every logit -inf) go to the lowest index, as in JAX
    dead = torch.full((2, 64), float("-inf")).to(dtype)
    np.testing.assert_array_equal(prng.categorical(prng.PRNGKey(0, DEV), dead).numpy(), [0, 0])
    np.testing.assert_array_equal(np.asarray(jax.random.categorical(
        jax.random.PRNGKey(0), jnp.full((2, 64), -jnp.inf, jdt))), [0, 0])


def test_rows_equal_jax_per_job_draws():
    """J jobs' Gumbel rows in one launch: ``rows(split_data(key, J), (t,),
    n)`` is JAX's ``vmap(lambda k: gumbel(fold_in(k, t), (n,)))(split(key,
    J))``, under a one-fold path and a two-fold one."""
    J, n, t = 6, 1000, 11
    keys = prng.split_data(prng.PRNGKey(4, DEV), J)
    jkeys = jax.random.split(jax.random.PRNGKey(4), J)
    np.testing.assert_array_equal(keys.data.numpy(), np.asarray(jax.random.key_data(jkeys)).view(np.int32))
    g = prng.rows(keys, (t,), n)
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(jax.random.fold_in(k, t), (n,)))(jkeys))
    assert g.shape == (J, n) and np.abs(g.numpy() - jg).max() <= 2e-6
    g2 = prng.rows(keys, (t, 3), n)
    jg2 = np.asarray(jax.vmap(lambda k: jax.random.gumbel(jax.random.fold_in(jax.random.fold_in(k, t), 3),
                                                          (n,)))(jkeys))
    assert np.abs(g2.numpy() - jg2).max() <= 2e-6


def _leaves(tree, prefix=""):
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{name}/"))
        else:
            out[f"{prefix}{name}"] = v
    return out


@pytest.mark.parametrize("arch,dtype", [("llama3-405b", None), ("qwen3-moe-30b-a3b", None),
                                        ("llama3-405b", "bfloat16")])
def test_model_init_equals_jax(arch, dtype):
    """``model.init(PRNGKey(1))``: a dense and an MoE arch of the zoo at
    smoke size (a stack drawn a layer at a time, an MoE weight an expert at
    a time), and the dense one in bfloat16 (cast, then scaled in bfloat16).  The
    CNN's (its conv kernels drawn HWIO, laid out OIHW) is held in
    ``tests/test_torch_fl_keys.py``, through ``FLServer.init_state``."""
    import dataclasses

    jcfg, cfg = jsmoke_variant(jget_config(arch)), smoke_variant(get_config(arch))
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype, param_dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    jp = _leaves(jbuild_model(jcfg).init(jax.random.PRNGKey(1))[0])
    tp = _leaves(build_model(cfg).init(prng.PRNGKey(1, DEV))[0])
    assert set(jp) == set(tp)
    for name, jv in jp.items():
        v = tp[name]
        assert tuple(v.shape) == jv.shape, name
        if dtype == "bfloat16":
            assert v.dtype == torch.bfloat16
            got = v.float().numpy().view(np.int32) >> 16
            want = np.asarray(jv.astype(jnp.float32)).view(np.int32) >> 16
            assert np.abs(got.astype(np.int64) - want).max() <= 1, name
        else:
            assert _ulps(v.numpy(), np.asarray(jv)).max() <= PARAM_ULPS, name

"""The kernel layer's public ops and their three kernels, port against the
JAX package on the CPU, on the same inputs made with numpy from a seed.

The JAX Pallas kernels run in interpret mode, as ``tests/test_kernels.py``
runs them, at its cases (ragged final tiles on purpose).  The port's
wrappers take their plain versions here (CPU tensors).

Tolerances, with their reasons:
- indices exact, and ``tmax`` exactly JAX's shape;
- top-k of given scores: values exact (both sides copy the scores);
- fused top-k: values within ``SCORE_ATOL`` (XLA and PyTorch may round a
  ``log`` differently in the last bit), indices exact on these tie-free
  inputs;
- the update: exact, both sides round the same float32 operations in the
  same order; against the core ``e3cs_update`` (which divides
  ``residual * eta * xhat`` by K where the kernel multiplies by
  ``scale = residual * eta / K``) within ``UPDATE_ATOL``, as
  ``test_e3cs_update_kernel_matches_reference`` holds JAX's kernel.

The Pallas streaming top-k orders exact ties by buffer slot and pads with
``(-1e30, 0)``; ``lax.top_k`` and the port order ties by index and pad with
``-inf`` at the lowest masked indices.  The port is held against the Pallas
kernel as sets plus descending values, and exactly against ``lax.top_k``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.selection import E3CSState as JE3CSState
from repro.core.selection import e3cs_update as je3cs_update
from repro.core.selection import prob_alloc as jprob_alloc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.e3cs_tiles import e3cs_update_kernel_call as je3cs_update_kernel_call
from repro.kernels.e3cs_tiles import fused_gumbel_topk_kernel_call as jfused_gumbel_topk_kernel_call
from repro.kernels.gumbel_topk import gumbel_topk_kernel_call as jgumbel_topk_kernel_call
from repro_torch.core.selection import E3CSState, e3cs_update
from repro_torch.kernels import (
    e3cs_update_kernel_call,
    fused_gumbel_topk_kernel_call,
    gumbel_topk_kernel_call,
    ops,
    ref,
)
from repro_torch.kernels import gumbel_topk as gumbel_topk_mod
from repro_torch.kernels._build import UnsupportedLaunch

SCORE_ATOL = 1e-6  # one float32 ulp of log(p) + g at |score| < 8
UPDATE_ATOL = 1e-6

# the JAX package's cases (tests/test_kernels.py): every K leaves a ragged tile
GUMBEL_CASES = [(7, 3, 8192), (7, 7, 8192), (100, 20, 48), (10000, 64, 4096), (10000, 200, 8192)]
GUMBEL_IDS = [f"K{K}-k{k}-t{t}" for K, k, t in GUMBEL_CASES]
UPDATE_CASES = [(100, 20, 48), (5000, 100, 1024)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _alloc(K, k, seed):
    """Allocation-like probabilities summing to k."""
    p = np.random.default_rng(seed).gamma(1.0, 1.0, K).astype(np.float32)
    return (p / p.sum() * k).astype(np.float32)


def _same_set_descending(got_v, got_i, want_v, want_i, atol):
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    assert sorted(got_i.tolist()) == sorted(want_i.tolist())
    assert len(set(got_i.tolist())) == len(got_i)
    np.testing.assert_allclose(np.asarray(got_v), np.asarray(want_v), rtol=0, atol=atol)
    assert (np.diff(np.asarray(got_v)) <= 0).all()


@pytest.mark.parametrize("K,k,tile", GUMBEL_CASES, ids=GUMBEL_IDS)
def test_gumbel_topk_matches_pallas_and_lax(K, k, tile):
    p = _alloc(K, k, seed=K + k)
    g = np.asarray(jax.random.gumbel(jax.random.PRNGKey(K + k), (K,), jnp.float32))
    scores = np.log(np.maximum(p, np.float32(1e-20))) + g
    vals, idx = gumbel_topk_kernel_call(_t(scores), k, tile=tile)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    jv, ji = jgumbel_topk_kernel_call(jnp.asarray(scores), k, tile=tile, interpret=True)
    _same_set_descending(vals.numpy(), idx.numpy(), jv, ji, atol=0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jref.gumbel_topk_ref(jnp.asarray(scores), k)))
    np.testing.assert_array_equal(vals.numpy(), scores[idx.numpy()])
    np.testing.assert_array_equal(ref.gumbel_topk_ref(_t(scores), k).numpy(), idx.numpy())


@pytest.mark.parametrize("K,k,tile", GUMBEL_CASES, ids=GUMBEL_IDS)
def test_fused_gumbel_topk_matches_pallas_and_lax(K, k, tile):
    p = _alloc(K, k, seed=K + 2 * k)
    p[10::11] = 0.0  # masked clients; every case keeps at least k positive
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(K), (K,), jnp.float32))
    vals, idx = fused_gumbel_topk_kernel_call(_t(p), _t(u), k, tile=tile)
    jv, ji = jfused_gumbel_topk_kernel_call(jnp.asarray(p), jnp.asarray(u), k, tile=tile, interpret=True)
    _same_set_descending(vals.numpy(), idx.numpy(), jv, ji, atol=SCORE_ATOL)
    g = -jnp.log(-jnp.log(jnp.clip(jnp.asarray(u), 1e-20, 1.0 - 1e-7)))
    s = jnp.where(jnp.asarray(p) > 0, jnp.log(jnp.maximum(jnp.asarray(p), 1e-20)) + g, -jnp.inf)
    lv, li = jax.lax.top_k(s, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(li))
    np.testing.assert_allclose(vals.numpy(), np.asarray(lv), rtol=0, atol=SCORE_ATOL)
    assert not (p[idx.numpy()] <= 0).any()


def test_fused_gumbel_topk_fewer_than_k_positive():
    """5 positive clients, k = 20: the port fills with -inf at the lowest
    indices with p <= 0 (the plain version's top-k order); the Pallas kernel
    fills with -1e30 at index 0, repeated."""
    K, k, tile = 100, 20, 48
    p = np.zeros(K, np.float32)
    pos = np.array([3, 17, 42, 64, 99])
    p[pos] = np.float32(0.2)
    u = np.random.default_rng(1).random(K).astype(np.float32)
    vals, idx = fused_gumbel_topk_kernel_call(_t(p), _t(u), k, tile=tile)
    assert sorted(idx[:5].tolist()) == pos.tolist() and bool(torch.isfinite(vals[:5]).all())
    assert idx[5:].tolist() == [i for i in range(K) if i not in pos][:15]
    assert bool(torch.isneginf(vals[5:]).all())
    jv, ji = jfused_gumbel_topk_kernel_call(jnp.asarray(p), jnp.asarray(u), k, tile=tile, interpret=True)
    assert sorted(np.asarray(ji)[:5].tolist()) == pos.tolist()
    assert np.asarray(ji)[5:].tolist() == [0] * 15 and (np.asarray(jv)[5:] == np.float32(-1e30)).all()


def _update_inputs(K, k, seed):
    rng = np.random.default_rng(seed)
    logw = jnp.asarray(rng.normal(0, 1, K).astype(np.float32))
    sigma = jnp.float32(0.3 * k / K)
    w = jnp.exp(logw - jnp.max(logw))
    p, capped = jprob_alloc(w, k, sigma)
    mask = jnp.zeros(K).at[jax.lax.top_k(p, k)[1]].set(1.0)
    x = jnp.asarray((rng.random(K) < 0.6).astype(np.float32))
    return logw, p, capped, mask, x, sigma


@pytest.mark.parametrize("K,k,tile", UPDATE_CASES)
def test_e3cs_update_kernel_matches_pallas(K, k, tile):
    logw, p, capped, mask, x, sigma = _update_inputs(K, k, seed=K)
    scale = (k - K * sigma) * 0.5 / K
    jnew, jtmax = je3cs_update_kernel_call(logw, p, mask, x, capped.astype(jnp.float32), scale, tile=tile,
                                           interpret=True)
    rows = [_t(np.asarray(a)) for a in (logw, p, mask, x, capped.astype(jnp.float32))]
    new, tmax = e3cs_update_kernel_call(*rows, _t(np.asarray(scale)), tile=tile)
    assert tuple(tmax.shape) == tuple(jtmax.shape) == (-(-K // tile),)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jtmax))


@pytest.mark.parametrize("K,tile", [(7, 8192), (7, 3), (100, 48), (100, 100), (5000, 1024), (5000, 32768)])
def test_e3cs_update_tmax_shape_matches_pallas(K, tile):
    """``tmax`` has ``ceil(K / min(tile, max(K, 8)))`` entries, as the Pallas
    grid has tiles."""
    rng = np.random.default_rng(K + tile)
    rows = [rng.normal(size=K).astype(np.float32), rng.uniform(0.1, 1, K).astype(np.float32),
            (rng.random(K) < 0.3).astype(np.float32), np.ones(K, np.float32), np.zeros(K, np.float32)]
    _, jtmax = je3cs_update_kernel_call(*map(jnp.asarray, rows), 0.05, tile=tile, interpret=True)
    new, tmax = e3cs_update_kernel_call(*map(_t, rows), 0.05, tile=tile)
    assert tuple(tmax.shape) == tuple(jtmax.shape)
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jtmax))
    assert float(tmax.max()) == float(new.max())


# ---------------------------------------------------------------------------
# the ops trio: port against JAX ops, JAX's own draws handed over
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_kernels(monkeypatch):
    """JAX ops on the Pallas kernels (interpret mode on the CPU)."""
    monkeypatch.setenv("REPRO_INTERPRET", "1")


@pytest.mark.parametrize("K,k,tile", GUMBEL_CASES, ids=GUMBEL_IDS)
def test_gumbel_topk_sample_matches_jax_ops(jax_kernels, K, k, tile):
    p = _alloc(K, k, seed=3 * K + k)
    key = jax.random.PRNGKey(K * k)
    g = np.asarray(jax.random.gumbel(key, (K,), jnp.float32))  # the draw inside jax ops
    want = np.asarray(jops.gumbel_topk_sample(key, jnp.asarray(p), k, tile=tile))
    got = ops.gumbel_topk_sample(_t(g), _t(p), k, tile=tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K,k,tile", GUMBEL_CASES, ids=GUMBEL_IDS)
def test_fused_gumbel_topk_sample_matches_jax_ops(jax_kernels, K, k, tile):
    p = _alloc(K, k, seed=5 * K + k)
    key = jax.random.PRNGKey(K + 7 * k)
    u = np.asarray(jax.random.uniform(key, (K,), jnp.float32))  # the draw inside jax ops
    want = np.asarray(jops.fused_gumbel_topk_sample(key, jnp.asarray(p), k, tile=tile))
    got = ops.fused_gumbel_topk_sample(_t(u), _t(p), k, tile=tile)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K,k,tile", UPDATE_CASES)
def test_e3cs_update_tiled_matches_jax_ops_and_core_update(jax_kernels, K, k, tile):
    logw, p, capped, mask, x, sigma = _update_inputs(K, k, seed=2 * K)
    eta = 0.5
    scale = (k - K * sigma) * eta / K
    frozen = capped.astype(jnp.float32)
    want = np.asarray(jops.e3cs_update_tiled(logw, p, mask, x, frozen, scale, tile=tile))
    tl = [_t(np.asarray(a)) for a in (logw, p, mask, x, frozen)]
    got = ops.e3cs_update_tiled(*tl, _t(np.asarray(scale)), tile=tile)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref.e3cs_update_tiled_ref(*tl, _t(np.asarray(scale))).numpy())
    assert float(got.max()) == 0.0
    # the port's own core update (Eqs. 16-17 in the staged order), and JAX's
    core = e3cs_update(E3CSState(logw=tl[0], t=torch.zeros((), dtype=torch.int32)), tl[1], _t(np.asarray(capped)),
                       tl[2], tl[3], k, _t(np.asarray(sigma)), eta)
    np.testing.assert_allclose(got.numpy(), core.logw.numpy(), rtol=0, atol=UPDATE_ATOL)
    jcore = je3cs_update(JE3CSState(logw=logw, t=jnp.zeros((), jnp.int32)), p, capped, mask, x, k, sigma, eta)
    np.testing.assert_allclose(got.numpy(), np.asarray(jcore.logw), rtol=0, atol=UPDATE_ATOL)


def test_ops_sample_distribution():
    """Inclusion frequency favours high-probability arms (the JAX package's
    ``test_gumbel_topk_sampler_distribution``, noise from a torch.Generator)."""
    from repro_torch.core.selection.sampling import gumbel_row, uniform_row

    p = torch.tensor([0.05] * 16 + [0.8] * 4)
    p = p / p.sum() * 4
    gen = torch.Generator().manual_seed(0)
    hits, hits_fused = np.zeros(20), np.zeros(20)
    for _ in range(300):
        hits[ops.gumbel_topk_sample(gumbel_row(gen, 20, "cpu"), p, 4, tile=32).numpy()] += 1
        hits_fused[ops.fused_gumbel_topk_sample(uniform_row(gen, 20, "cpu"), p, 4, tile=32).numpy()] += 1
    assert hits[16:].mean() > 4 * hits[:16].mean()
    assert hits_fused[16:].mean() > 4 * hits_fused[:16].mean()


# ---------------------------------------------------------------------------
# a CUDA tensor never falls back: unsupported launches raise before a launch
# ---------------------------------------------------------------------------


@pytest.fixture
def as_if_cuda(monkeypatch):
    """Route device-free (meta) tensors as CUDA tensors are routed, so the
    wrapper's checks before a launch run without a card."""
    from repro_torch.kernels import e3cs_tiles

    for mod in (gumbel_topk_mod, e3cs_tiles):
        monkeypatch.setattr(mod, "route", lambda t: True)


@pytest.mark.parametrize("tile,k", [(48, 20), (32768, 100), (8192, 2049), (4096, 2049), (16384, 4000)])
def test_unsupported_topk_launch_raises_on_cuda_route(as_if_cuda, tile, k):
    z = torch.empty(50_000, device="meta")
    with pytest.raises(UnsupportedLaunch):
        gumbel_topk_kernel_call(z, k, tile=tile)
    with pytest.raises(UnsupportedLaunch):
        fused_gumbel_topk_kernel_call(z, z, k, tile=tile)
    with pytest.raises(UnsupportedLaunch):
        ops.gumbel_topk_sample(z, z, k, tile=tile)
    assert gumbel_topk_kernel_call.launches == 0 and fused_gumbel_topk_kernel_call.launches == 0


def test_supported_topk_pairs():
    # the radix select takes any k <= MAX_K at every tile: no tile must hold two lists of k
    for tile, k in ((2048, 1000), (16384, 2048), (4096, 1), (2048, 1025), (2048, 2048)):
        assert gumbel_topk_mod.topk_launch(tile, k) is None
    # the same pairs take the plain version on the CPU, for any tile
    s = torch.arange(10, dtype=torch.float32)
    assert gumbel_topk_kernel_call(s, 3, tile=48)[1].tolist() == [9, 8, 7]


def test_wrappers_refuse_a_device_with_no_kernel():
    z = torch.zeros(64, device="meta")
    with pytest.raises(RuntimeError, match="meta"):
        gumbel_topk_kernel_call(z, 4)
    with pytest.raises(RuntimeError, match="meta"):
        fused_gumbel_topk_kernel_call(z, z, 4)
    with pytest.raises(RuntimeError, match="meta"):
        e3cs_update_kernel_call(z, z, z, z, z, 0.1)

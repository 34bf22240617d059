"""``bisect_block_sums``'s plain PyTorch version against the JAX package: its
jnp reference and its Pallas kernel run in interpret mode, on the same
weights and caps made with numpy from a seed, at ragged K and both tile
widths, for 1 to 63 caps; float64 against the reference under
``jax.enable_x64``.

Tolerance: every sum is the same per-tile-then-across-tiles reduction, but
XLA, the Pallas interpreter and PyTorch each add a tile's terms in their own
order, so sums of thousands of float32 terms may differ in their last bits:
``RTOL = 1e-6``, and ``RTOL64 = 1e-12`` in float64.
``test_torch_kernels_cuda.py`` holds the CUDA kernel against this plain
version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bisect_tiles import bisect_block_sums_kernel_call, bisect_block_sums_ref as jbisect_ref
from repro_torch.kernels import bisect_block_sums, ref
from test_torch_kernels_cuda import bisect_inputs

RTOL, RTOL64 = 1e-6, 1e-12


@pytest.mark.parametrize("n_caps", [1, 3, 15, 63])
@pytest.mark.parametrize("tile", [512, 8192])
@pytest.mark.parametrize("K", [1, 100, 8192, 20000])
def test_plain_matches_jax_reference(K, tile, n_caps):
    w, caps = bisect_inputs(K, n_caps)
    want = np.asarray(jbisect_ref(jnp.asarray(w), jnp.asarray(caps), tile=tile))
    got = ref.bisect_block_sums_ref(torch.from_numpy(w), torch.from_numpy(caps), tile=tile)
    assert got.dtype == torch.float32 and got.shape == (n_caps,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("n_caps", [3, 63])
@pytest.mark.parametrize("tile", [512, 8192])
@pytest.mark.parametrize("K", [1, 100, 8192, 20000])
def test_plain_matches_pallas_interpret(K, tile, n_caps):
    w, caps = bisect_inputs(K, n_caps)
    want = np.asarray(bisect_block_sums_kernel_call(jnp.asarray(w), jnp.asarray(caps), tile=tile, interpret=True))
    got = ref.bisect_block_sums_ref(torch.from_numpy(w), torch.from_numpy(caps), tile=tile)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("K", [100, 20000])
def test_float64_matches_jax_reference(K):
    w, caps = bisect_inputs(K, 15, dtype=np.float64)
    with jax.enable_x64(True):
        want = np.asarray(jbisect_ref(jnp.asarray(w), jnp.asarray(caps), tile=512))
        assert want.dtype == np.float64
    got = ref.bisect_block_sums_ref(torch.from_numpy(w), torch.from_numpy(caps), tile=512)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL64, atol=0)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    w, caps = (torch.from_numpy(a) for a in bisect_inputs(20000, 15))
    bisect_block_sums.launches = 0
    torch.testing.assert_close(bisect_block_sums(w, caps), ref.bisect_block_sums_ref(w, caps), rtol=0, atol=0)
    assert bisect_block_sums.launches == 0


def test_wrapper_refuses_a_device_with_no_kernel():
    with pytest.raises(RuntimeError, match="meta"):
        bisect_block_sums(torch.zeros(8, device="meta"), torch.zeros(3, device="meta"))


@pytest.mark.parametrize("K", [100, 20000])
def test_wrapper_resolves_tile_none_through_the_autotune_cache(K, monkeypatch, tmp_path):
    """``bisect_block_sums(w, caps)`` with no tile: the port and the JAX
    package each look it up in their autotune cache, here an empty one, so
    both take the default tile 8192.  On weights and caps that are multiples
    of 1/8 below 16, every partial sum is exact in float32, whatever the order
    of the additions: the port equals JAX's ``bisect_block_sums`` bit for bit.
    On gamma weights it equals its plain version at tile 8192 bit for bit."""
    from repro.kernels.autotune import best_config as jbest_config
    from repro.kernels.bisect_tiles import bisect_block_sums as jbisect_block_sums
    from repro_torch.kernels.autotune import best_config

    monkeypatch.setenv("REPRO_AUTOTUNE_DIR", str(tmp_path))
    assert best_config("bisect_tiles", K, backend="cpu")["tile"] == jbest_config("bisect_tiles", K)["tile"] == 8192
    rng = np.random.default_rng(K)
    w = (rng.integers(0, 128, K) / 8).astype(np.float32)
    caps = np.sort(rng.integers(0, 128, 15) / 8).astype(np.float32)
    want = np.asarray(jbisect_block_sums(jnp.asarray(w), jnp.asarray(caps)))
    got = bisect_block_sums(torch.from_numpy(w), torch.from_numpy(caps))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    w, caps = (torch.from_numpy(a) for a in bisect_inputs(K, 15))
    torch.testing.assert_close(bisect_block_sums(w, caps), ref.bisect_block_sums_ref(w, caps, tile=8192),
                               rtol=0, atol=0)

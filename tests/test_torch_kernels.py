"""Each kernel's plain PyTorch version against the JAX package's Pallas
kernel run in interpret mode, on the same inputs made with numpy from a seed:
ragged K (130, with a tile of 64), every outcome kind, S in {0, 2}, late
feedback on and off, with and without an activity mask.

Indices, masks, lags and codes must be equal exactly.  Elementwise floats
(``p``, ``logw_pre``, rings, loss cache) are the same float32 operations in
the same order and must be equal exactly too.  Scores take a ``log``, which
XLA and PyTorch may round differently in the last bit: ``SCORE_RTOL``.

``test_torch_kernels_cuda.py`` holds each CUDA kernel against its plain
version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.engine.sharded import masked_prob_alloc_scalars as jmasked_prob_alloc_scalars
from repro.kernels.round_fused import fused_select_kernel_call, round_tail_kernel_call
from repro.kernels.unpack_bits import unpack_bits_kernel_call, unpack_crumbs_kernel_call
from repro_torch.kernels import ref, unpack_bits, unpack_crumbs
from test_torch_kernels_cuda import TAIL_CASES, TAIL_IDS, _t, select_inputs, tail_inputs

RAGGED_K, TILE, KK = 130, 64, 16
SCORE_RTOL = 1e-6  # one float32 ulp of log(p) + g at |score| ~ 10


# ---------------------------------------------------------------------------
# unpack_bits / unpack_crumbs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [7, RAGGED_K, 1000])
def test_unpack_bits_ref_matches_pallas(K):
    packed = np.random.default_rng(K).integers(0, 256, (K + 7) // 8, dtype=np.uint8)
    want = unpack_bits_kernel_call(jnp.asarray(packed), K, tile_b=16, interpret=True)
    np.testing.assert_array_equal(ref.unpack_bits_ref(_t(packed), K).numpy(), np.asarray(want))


@pytest.mark.parametrize("K", [5, RAGGED_K, 1000])
def test_unpack_crumbs_ref_matches_pallas(K):
    packed = np.random.default_rng(K).integers(0, 256, (K + 3) // 4, dtype=np.uint8)
    want = unpack_crumbs_kernel_call(jnp.asarray(packed), K, tile_b=16, interpret=True)
    np.testing.assert_array_equal(ref.unpack_crumbs_ref(_t(packed), K).numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["bits", "crumbs"])
@pytest.mark.parametrize("row", [1, 3, 5, 7, 9, 11, 13, 15])
def test_unpack_wrappers_on_trace_rows_match_pallas(row, kind):
    """Row views of a ``(16, B)`` trace with B = 17 bytes, as the staged
    replay hands them to the wrappers: row t starts at byte offset 17 t, odd
    for odd t (t mod 16 bytes past a 16-byte boundary).  Each view through
    the port's wrapper equals the Pallas kernel on that row."""
    per = 8 if kind == "bits" else 4
    K = 17 * per - 3  # a ragged last byte
    trace = np.random.default_rng(row).integers(0, 256, (16, 17), dtype=np.uint8)
    view = _t(trace)[row]
    assert view.storage_offset() == 17 * row
    port, pallas = ((unpack_bits, unpack_bits_kernel_call) if kind == "bits"
                    else (unpack_crumbs, unpack_crumbs_kernel_call))
    want = pallas(jnp.asarray(trace[row]), K, tile_b=16, interpret=True)
    np.testing.assert_array_equal(port(view, K).numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# select: allocation epilogue + perturb + top-k
# ---------------------------------------------------------------------------


def _select_inputs(with_active=False):
    w, g, active, sigma = select_inputs(RAGGED_K, KK, with_active=with_active)
    scal = jmasked_prob_alloc_scalars(jnp.asarray(w), KK, jnp.float32(sigma),
                                      active=None if active is None else jnp.asarray(active))
    return w, g, active, sigma, tuple(np.asarray(s) for s in scal)


def _port_scalars(sigma, scal, device="cpu"):
    residual, cap, denom, use_cap = (_t(s, device) for s in scal)
    return _t(sigma, device), (residual, cap, denom, use_cap)


@pytest.mark.parametrize("with_active", [False, True], ids=["dense", "active"])
def test_alloc_select_ref_matches_pallas(with_active):
    w, g, active, sigma, scal = _select_inputs(with_active=with_active)
    act = None if active is None else jnp.asarray(active)
    p_j, c_j, v_j, i_j = fused_select_kernel_call(
        jnp.asarray(w), jnp.asarray(g), KK, scalars=scal, sigma=sigma, active=act, tile=TILE, interpret=True
    )
    sig, scalars = _port_scalars(sigma, scal)
    p, capped, vals, idx = ref.fused_alloc_select_ref(
        _t(w), _t(g), KK, sigma=sig, scalars=scalars, active=None if active is None else _t(active)
    )
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(capped.numpy(), np.asarray(c_j) > 0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(vals.numpy(), np.asarray(v_j), rtol=SCORE_RTOL)


@pytest.mark.parametrize("with_active", [False, True], ids=["dense", "active"])
def test_perturb_select_ref_matches_pallas(with_active):
    w, g, active, _, _ = _select_inputs(with_active=with_active)
    p = np.clip(w / w.sum() * KK, 0.0, 1.0).astype(np.float32)
    act = None if active is None else jnp.asarray(active)
    v_j, i_j = fused_select_kernel_call(jnp.asarray(p), jnp.asarray(g), KK, active=act, tile=TILE, interpret=True)
    vals, idx = ref.fused_perturb_select_ref(_t(p), _t(g), KK, active=None if active is None else _t(active))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(vals.numpy(), np.asarray(v_j), rtol=SCORE_RTOL)


def test_topk_ties_resolve_like_lax_top_k():
    """Equal scores resolve lowest index first, as ``lax.top_k`` does."""
    p = np.full(RAGGED_K, 0.1, np.float32)
    g = np.repeat(np.arange(13, dtype=np.float32), 10)  # ten-way ties
    v_j, i_j = jax.lax.top_k(jnp.log(jnp.maximum(jnp.asarray(p), 1e-20)) + jnp.asarray(g), 25)
    vals, idx = ref.fused_perturb_select_ref(_t(p), _t(g), 25)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(v_j))


# ---------------------------------------------------------------------------
# tail: decode + Eq. 16/17 + rings + loss cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_active", [False, True], ids=["dense", "active"])
@pytest.mark.parametrize("kind,S,late_fb", TAIL_CASES, ids=TAIL_IDS)
def test_round_tail_ref_matches_pallas(kind, S, late_fb, with_active):
    args, active, kw = tail_inputs(RAGGED_K, kind=kind, S=S, with_active=with_active, late_fb=late_fb)
    jargs = tuple(None if a is None else jnp.asarray(a) for a in args)
    jkw = dict(kw, residual=jnp.float32(kw["residual"]))
    want = round_tail_kernel_call(*jargs, **jkw, active=None if active is None else jnp.asarray(active),
                                  tile=TILE, interpret=True)
    targs = tuple(None if a is None else _t(a) for a in args)
    got = ref.round_tail_ref(*targs, **dict(kw, residual=_t(kw["residual"])),
                             active=None if active is None else _t(active))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=f"tail product {key!r}")

"""Each CUDA kernel against its plain PyTorch version on the card, at ragged
K and at the main path's K = 1,000,003 and k up to 2048, on inputs made with
numpy from a seed.  The round kernels repeat their plain versions' float32
operations in the same order (built with ``--fmad=false``), so every product
must be equal exactly.  ``bisect_block_sums`` adds a tile's terms in another
order than ``torch.sum``: ``BISECT_RTOL``.

This file imports no JAX, so it runs where the card is:
``PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py``.
Without a card every test skips.  ``test_torch_kernels.py`` holds the same
plain versions against the JAX package's Pallas kernels, from the helpers
below.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    bisect_block_sums,
    fused_alloc_select,
    fused_perturb_select,
    fused_round_tail,
    ref,
    unpack_bits,
    unpack_crumbs,
)

# float32 sums of up to 8192 terms per tile, then of the tiles, in another
# order than torch.sum takes them: a few units in the last place
BISECT_RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def select_inputs(n, k, with_active=False, seed=5):
    """Weights, Gumbel row, optional activity mask and a feasible sigma."""
    rng = np.random.default_rng(seed)
    w = rng.gamma(1.0, 1.0, n).astype(np.float32)
    g = rng.gumbel(size=n).astype(np.float32)
    active = (rng.random(n) < 0.85).astype(np.float32) if with_active else None
    if active is not None:
        w = w * active
    return w, g, active, np.float32(0.3 * k / n)


def bisect_inputs(n, n_caps, dtype=np.float32, seed=3):
    """Non-negative weights with a zero every 7th client (padding adds
    nothing) and sorted caps drawn inside ``[0, max w]``."""
    rng = np.random.default_rng(seed + n)
    w = rng.gamma(1.0, 1.0, n)
    w[::7] = 0.0
    caps = np.sort(rng.uniform(0.0, max(float(w.max()), 1e-3), n_caps))
    return w.astype(dtype), caps.astype(dtype)


def tail_inputs(n, kind="bits", S=2, with_active=False, late_fb=False, seed=9):
    """``(obs, mask, p, capped, logw, loss, credit, fb)``, the activity mask
    and the keyword arguments of one tail pass."""
    rng = np.random.default_rng(seed)
    p = rng.gamma(1.0, 1.0, n).astype(np.float32)
    p = np.clip(p / p.sum() * 16, 0.01, 0.97).astype(np.float32)
    mask = (rng.random(n) < 0.2).astype(np.float32)
    capped = rng.random(n) < 0.1
    logw = rng.normal(0, 1, n).astype(np.float32)
    loss = rng.random(n).astype(np.float32)
    if kind == "bits":
        obs = rng.integers(0, 256, (n + 7) // 8, dtype=np.uint8)
    elif kind == "crumbs":
        obs = rng.integers(0, 256, (n + 3) // 4, dtype=np.uint8)
    elif kind == "x":
        obs = (rng.random(n) < 0.6).astype(np.float32)
    else:
        obs = rng.choice(np.array([-1, 0, 1, 2], np.int32), n)
    credit = rng.random((S, n)).astype(np.float32) if S else None
    fb = rng.normal(0, 0.1, (S, n)).astype(np.float32) if late_fb else None
    active = (rng.random(n) < 0.9).astype(np.float32) if with_active else None
    kw = dict(kind=kind, residual=np.float32(16.0 - n * 0.02), eta=0.5, K_glob=n,
              decay=tuple(0.5 ** (s + 1) for s in range(S)))
    return (obs, mask, p, capped, logw, loss, credit, fb), active, kw


TAIL_CASES = [(kind, 0, False) for kind in ("bits", "x")] + [
    (kind, S, fb) for kind in ("crumbs", "lag") for S, fb in ((0, False), (2, False), (2, True))
]
TAIL_IDS = [f"{c[0]}-S{c[1]}{'-fb' if c[2] else ''}" for c in TAIL_CASES]


@pytest.mark.parametrize("K", [1, 7, 8, 4099, 1_000_003])
def test_unpack_kernels_match_plain(cuda, K):
    rng = np.random.default_rng(K)
    bits = _t(rng.integers(0, 256, (K + 7) // 8, dtype=np.uint8), cuda)
    crumbs = _t(rng.integers(0, 256, (K + 3) // 4, dtype=np.uint8), cuda)
    torch.testing.assert_close(unpack_bits(bits, K), ref.unpack_bits_ref(bits, K), rtol=0, atol=0)
    torch.testing.assert_close(unpack_crumbs(crumbs, K), ref.unpack_crumbs_ref(crumbs, K), rtol=0, atol=0)


@pytest.mark.parametrize("K,k", [(130, 16), (8192, 1000), (8193, 2048), (1_000_003, 1000)])
@pytest.mark.parametrize("with_active", [False, True], ids=["dense", "active"])
def test_select_kernel_matches_plain(cuda, K, k, with_active):
    w, g, active, sigma = select_inputs(K, k, with_active=with_active, seed=K)
    # any scalars do: the kernel and its plain version take the same ones
    residual, cap, denom = k - K * sigma, np.quantile(w, 0.999), w.sum()
    scalars = tuple(_t(np.float32(v), cuda) for v in (residual, cap, denom)) + (_t(np.bool_(True), cuda),)
    sig, act, wt, gt = _t(sigma, cuda), None if active is None else _t(active, cuda), _t(w, cuda), _t(g, cuda)
    got = fused_alloc_select(wt, gt, k, sigma=sig, scalars=scalars, active=act)
    want = ref.fused_alloc_select_ref(wt, gt, k, sigma=sig, scalars=scalars, active=act)
    for name, a, b in zip(("p", "capped", "vals", "idx"), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    got_p = fused_perturb_select(want[0], gt, k, active=act)
    want_p = ref.fused_perturb_select_ref(want[0], gt, k, active=act)
    for name, a, b in zip(("vals", "idx"), got_p, want_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("K", [130, 1_000_003])
@pytest.mark.parametrize("with_active", [False, True], ids=["dense", "active"])
@pytest.mark.parametrize("kind,S,late_fb", TAIL_CASES, ids=TAIL_IDS)
def test_round_tail_kernel_matches_plain(cuda, kind, S, late_fb, with_active, K):
    args, active, kw = tail_inputs(K, kind=kind, S=S, with_active=with_active, late_fb=late_fb, seed=K)
    targs = [None if a is None else _t(a, cuda) for a in args]
    act = None if active is None else _t(active, cuda)
    kw = dict(kw, residual=_t(kw["residual"], cuda))
    want = ref.round_tail_ref(*targs, **kw, active=act)
    # the kernel shifts the rings in place: give it copies
    got = fused_round_tail(*(None if a is None else a.clone() for a in targs), **kw, active=act)
    assert set(got) == set(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=f"tail product {key!r}")


@pytest.mark.parametrize("n_caps", [1, 3, 15, 31, 63])
@pytest.mark.parametrize("tile", [512, 8192])
@pytest.mark.parametrize("K", [1, 100, 8193, 1_000_003])
def test_bisect_block_sums_kernel_matches_plain(cuda, K, tile, n_caps):
    w, caps = (_t(a, cuda) for a in bisect_inputs(K, n_caps))
    before = bisect_block_sums.launches
    got = bisect_block_sums(w, caps, tile=tile)
    assert bisect_block_sums.launches == before + 1
    torch.testing.assert_close(got, ref.bisect_block_sums_ref(w, caps, tile=tile), rtol=BISECT_RTOL[w.dtype], atol=0)


@pytest.mark.parametrize("K", [100, 1_000_003])
def test_bisect_block_sums_kernel_float64_and_unaligned(cuda, K):
    w, caps = (_t(a, cuda) for a in bisect_inputs(K + 1, 15, dtype=np.float64))
    torch.testing.assert_close(bisect_block_sums(w, caps), ref.bisect_block_sums_ref(w, caps),
                               rtol=BISECT_RTOL[torch.float64], atol=0)
    w32, c32 = w.float(), caps.float()
    view = w32[1:]  # 4 bytes past a 16-byte boundary: the kernel's element-wise path
    torch.testing.assert_close(bisect_block_sums(view, c32), ref.bisect_block_sums_ref(view, c32),
                               rtol=BISECT_RTOL[torch.float32], atol=0)
    with pytest.raises(TypeError, match="float32 or float64"):
        bisect_block_sums(w.half(), caps.half())

"""Each CUDA kernel against its plain PyTorch version on the card, at ragged
K and at the main path's K = 1,000,003 and k up to 2048, on inputs made with
numpy from a seed.  The round kernels, the top-k kernels and the update
kernel repeat their plain versions' float32 operations in the same order
(built with ``--fmad=false``, ``logf`` as ``torch.log`` calls it), so every
product must be equal exactly.  ``bisect_block_sums`` adds a tile's terms in
another order than ``torch.sum``: ``BISECT_RTOL``.

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
    e3cs_update_kernel_call,
    fused_alloc_select,
    fused_gumbel_topk_kernel_call,
    fused_perturb_select,
    fused_round_tail,
    gumbel_topk_kernel_call,
    ops,
    ref,
    unpack_bits,
    unpack_crumbs,
)
from repro_torch.kernels.gumbel_topk import TOPK_TILES

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
    caps = np.sort(rng.uniform(0.0, max(float(w.max(initial=0.0)), 1e-3), n_caps))
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


def topk_inputs(n, k, seed=11, zero_frac=0.1):
    """Allocation-like ``p`` (about ``zero_frac`` of it 0, so the fused
    kernel masks them), its uniform row ``u`` and the scores ``log p + g``
    of a Gumbel row."""
    rng = np.random.default_rng(seed)
    p = rng.gamma(1.0, 1.0, n).astype(np.float32)
    p = (p / p.sum() * k).astype(np.float32)
    p[rng.random(n) < zero_frac] = 0.0
    u = rng.random(n).astype(np.float32)
    g = rng.gumbel(size=n).astype(np.float32)
    scores = (np.log(np.maximum(p, np.float32(1e-20))) + g).astype(np.float32)
    return p, u, scores


# inputs that reach every path of the radix select: all scores equal (the
# digits reach the index word), fewer than k positive p (the -inf fill),
# one binade (the chosen bin overflows the candidate buffer), k = 1,
# k = 2048, K = k, and the ragged K = 1,000,003
ENGINE_CASES = [("equal", 1_000_003, 1000), ("few_positive", 1_000_003, 1000), ("binade", 1_000_003, 1000),
                ("gumbel", 1_000_003, 1), ("gumbel", 1_000_003, 2048), ("gumbel", 2048, 2048), ("equal", 2048, 2048)]
ENGINE_IDS = [f"{c}-K{K}-k{k}" for c, K, k in ENGINE_CASES]


def engine_select_inputs(case, n, k, with_active=False, seed=5):
    """``select_inputs`` and the scalars ``(residual, cap, denom)``, shaped
    into one of ``ENGINE_CASES``."""
    rng = np.random.default_rng(seed)
    w, g, active, sigma = select_inputs(n, k, with_active=with_active, seed=seed)
    ones = np.ones(n, np.float32) if active is None else active
    if case == "few_positive":
        ones = np.zeros(n, np.float32)
        ones[rng.permutation(n)[: k // 2]] = 1.0
        active = ones if active is not None else None
        w = w * ones
    if case in ("equal", "binade"):
        w = ones.copy()
        g = np.zeros(n, np.float32) if case == "equal" else rng.uniform(1.0, 2.0, n).astype(np.float32)
    if case == "binade":  # p = 1 everywhere: the scores are g, in [1, 2)
        return w, g, active, sigma, (np.float32(2.0), np.float32(1.0), np.float32(1.0))
    return w, g, active, sigma, (k - n * sigma, np.quantile(w, 0.999), w.sum())


def engine_topk_inputs(case, n, k, seed=11):
    """``topk_inputs`` shaped into one of ``ENGINE_CASES``."""
    rng = np.random.default_rng(seed)
    p, u, scores = topk_inputs(n, k, seed=seed)
    if case == "equal":
        p, u, scores = (np.full(n, v, np.float32) for v in (0.3, 0.4, 0.5))
    elif case == "few_positive":
        keep = np.zeros(n, bool)
        keep[rng.permutation(n)[: k // 2]] = True
        p = np.where(keep, p + np.float32(0.01), np.float32(0.0)).astype(np.float32)
        scores = np.where(keep, scores, np.float32(-np.inf)).astype(np.float32)
    elif case == "binade":  # log p + Gumbel(u) and the scores in [1, 2)
        p = np.full(n, np.exp(1.5), np.float32)
        u = rng.uniform(0.2, 0.54, n).astype(np.float32)
        scores = rng.uniform(1.0, 2.0, n).astype(np.float32)
    return p, u, scores


def update_inputs(n, k, seed=13):
    """``(logw, p, sel_mask, x, frozen)`` of one E3CS update and its float32
    ``scale = (k - K sigma) * eta / K``."""
    rng = np.random.default_rng(seed)
    logw = rng.normal(0, 1, n).astype(np.float32)
    p = np.clip(rng.gamma(1.0, 1.0, n) / n * k, 1e-3, 1.0).astype(np.float32)
    mask = (rng.random(n) < min(1.0, k / n)).astype(np.float32)
    x = (rng.random(n) < 0.6).astype(np.float32)
    frozen = (rng.random(n) < 0.05).astype(np.float32)
    sigma = 0.3 * k / n
    return (logw, p, mask, x, frozen), np.float32((k - n * sigma) * 0.5 / n)


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


def check_select(cuda, w, g, active, sigma, residual, cap, denom, k):
    """from_w and from_p select against their plain versions, bit for bit."""
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


@pytest.mark.parametrize("K,k", [(130, 16), (8192, 1000), (8193, 2048), (1_000_003, 1000)])
@pytest.mark.parametrize("with_active", [False, True], ids=["dense", "active"])
def test_select_kernel_matches_plain(cuda, K, k, with_active):
    w, g, active, sigma = select_inputs(K, k, with_active=with_active, seed=K)
    # any scalars do: the kernel and its plain version take the same ones
    check_select(cuda, w, g, active, sigma, k - K * sigma, np.quantile(w, 0.999), w.sum(), k)


@pytest.mark.parametrize("case,K,k", ENGINE_CASES, ids=ENGINE_IDS)
@pytest.mark.parametrize("with_active", [False, True], ids=["dense", "active"])
def test_select_kernel_exact_on_every_engine_path(cuda, case, K, k, with_active):
    w, g, active, sigma, (residual, cap, denom) = engine_select_inputs(case, K, k, with_active=with_active, seed=K)
    check_select(cuda, w, g, active, sigma, residual, cap, denom, k)


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


def test_bisect_block_sums_kernel_ticket_resets_over_1000_calls(cuda):
    """One launch a call, its last CTA found by a ticket that it resets: 1000
    calls in a row, alternating a 123-CTA grid of 15 caps with a 2-CTA grid
    of 63, each equal bit for bit to the first call of its shape."""
    shapes = [tuple(_t(a, cuda) for a in bisect_inputs(K, n_caps)) for K, n_caps in ((1_000_000, 15), (8193, 63))]
    before = bisect_block_sums.launches
    outs = [bisect_block_sums(*shapes[i % 2]) for i in range(1000)]
    assert bisect_block_sums.launches == before + 1000
    for i, got in enumerate(outs):
        torch.testing.assert_close(got, outs[i % 2], rtol=0, atol=0, msg=f"call {i}")
    for (w, caps), got in zip(shapes, outs[:2]):
        torch.testing.assert_close(got, ref.bisect_block_sums_ref(w, caps), rtol=BISECT_RTOL[w.dtype], atol=0)


def test_bisect_block_sums_kernel_graph_replay_bit_identical(cuda):
    """20 calls captured in one CUDA graph, replayed 3 times: every output
    equals the eager call bit for bit."""
    w, caps = (_t(a, cuda) for a in bisect_inputs(1_000_000, 15))
    want = bisect_block_sums(w, caps)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [bisect_block_sums(w, caps) for _ in range(20)]
    for replay in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for i, got in enumerate(outs):
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=f"replay {replay}, call {i}")


def test_bisect_block_sums_kernel_graphs_take_their_own_ticket_slots(cuda):
    """Each graph capture takes a ticket slot of its own, apart from the
    capture stream's eager slot: two graphs captured on the same stream,
    replayed at the same time on two streams 50 times, each give the eager
    call's bits every time."""
    from repro_torch.kernels import bisect_tiles

    w, caps = (_t(a, cuda) for a in bisect_inputs(1_000_000, 15))
    want = bisect_block_sums(w, caps)
    capture = torch.cuda.Stream()
    with torch.cuda.stream(capture):
        bisect_block_sums(w, caps)
    torch.cuda.synchronize()
    eager = bisect_tiles._slots[(w.device.index, capture.cuda_stream, None)]
    graphs, outs, slots = [], [], []
    for _ in range(2):
        before = dict(bisect_tiles._slots)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=capture):
            outs.append([bisect_block_sums(w, caps) for _ in range(4)])
        new = {key: s for key, s in bisect_tiles._slots.items() if key not in before}
        assert len(new) == 1 and next(iter(new))[:2] == (w.device.index, capture.cuda_stream)
        graphs.append(graph)
        slots.append(next(iter(new.values())))
    assert len({eager, *slots}) == 3
    streams = [torch.cuda.Stream() for _ in graphs]
    for replay in range(50):
        for o in outs:
            for x in o:
                x.zero_()
        torch.cuda.synchronize()
        for graph, stream in zip(graphs, streams):
            with torch.cuda.stream(stream):
                graph.replay()
        torch.cuda.synchronize()
        for o in outs:
            for got in o:
                torch.testing.assert_close(got, want, rtol=0, atol=0, msg=f"replay {replay}")


@pytest.mark.parametrize("n_caps", [1, 15, 63])
@pytest.mark.parametrize("K", [0, 5000])
def test_bisect_block_sums_kernel_single_cta(cuda, K, n_caps):
    """K below the tile: a grid of one CTA, which is also the last (K = 0
    too: its empty tile sums to 0)."""
    w, caps = (_t(a, cuda) for a in bisect_inputs(K, n_caps))
    got = bisect_block_sums(w, caps, tile=8192)
    torch.testing.assert_close(got, ref.bisect_block_sums_ref(w, caps, tile=8192), rtol=BISECT_RTOL[w.dtype], atol=0)
    if K == 0:
        assert not bool(got.any())


TOPK_CASES = [(7, 3), (100, 20), (8193, 1000), (1_000_003, 1000)]


def check_topk(p, u, scores, k, tile):
    """Both top-k kernels against their plain versions, bit for bit, one
    launch each."""
    before = (gumbel_topk_kernel_call.launches, fused_gumbel_topk_kernel_call.launches)
    for name, a, b in zip(("vals", "idx"), gumbel_topk_kernel_call(scores, k, tile=tile),
                          ref.gumbel_topk_kernel_ref(scores, k)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"gumbel_topk {name}")
    for name, a, b in zip(("vals", "idx"), fused_gumbel_topk_kernel_call(p, u, k, tile=tile),
                          ref.fused_gumbel_topk_kernel_ref(p, u, k)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"fused_gumbel_topk {name}")
    assert (gumbel_topk_kernel_call.launches, fused_gumbel_topk_kernel_call.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("tile", TOPK_TILES)
@pytest.mark.parametrize("K,k", TOPK_CASES, ids=[f"K{K}-k{k}" for K, k in TOPK_CASES])
def test_topk_kernels_match_plain(cuda, K, k, tile):
    check_topk(*(_t(a, cuda) for a in topk_inputs(K, k, seed=K)), k, tile)


@pytest.mark.parametrize("tile", TOPK_TILES)
@pytest.mark.parametrize("case,K,k", ENGINE_CASES, ids=ENGINE_IDS)
def test_topk_kernels_exact_on_every_engine_path(cuda, case, K, k, tile):
    check_topk(*(_t(a, cuda) for a in engine_topk_inputs(case, K, k, seed=K)), k, tile)


def test_fused_topk_kernel_with_fewer_than_k_positive(cuda):
    """Fewer than k clients with p > 0: the tail is -inf at the lowest
    indices with p <= 0, as the plain version's top-k order gives."""
    K, k = 10_000, 100
    p, u, _ = topk_inputs(K, k, seed=3, zero_frac=0.0)
    p[np.random.default_rng(4).permutation(K)[40:]] = 0.0
    pt, ut = _t(p, cuda), _t(u, cuda)
    vals, idx = fused_gumbel_topk_kernel_call(pt, ut, k, tile=4096)
    want_v, want_i = ref.fused_gumbel_topk_kernel_ref(pt, ut, k)
    torch.testing.assert_close(vals, want_v, rtol=0, atol=0)
    torch.testing.assert_close(idx, want_i, rtol=0, atol=0)
    assert bool(torch.isinf(vals[40:]).all())
    assert idx[40:].tolist() == np.flatnonzero(p <= 0)[:60].tolist()


@pytest.mark.parametrize("tile", [48, 1024, 8192, 32768])
@pytest.mark.parametrize("K,k", [(7, 3), (100, 20), (5000, 100), (1_000_003, 1000)])
def test_e3cs_update_kernel_matches_plain(cuda, K, k, tile):
    rows, scale = update_inputs(K, k, seed=K)
    rows = [_t(a, cuda) for a in rows]
    sc = _t(scale, cuda)
    before = e3cs_update_kernel_call.launches
    new, tmax = e3cs_update_kernel_call(*rows, sc, tile=tile)
    assert e3cs_update_kernel_call.launches == before + 1
    want_new, want_tmax = ref.e3cs_update_kernel_ref(*rows, sc, tile=tile)
    assert tmax.shape == (-(-K // min(tile, max(K, 8))),)
    torch.testing.assert_close(new, want_new, rtol=0, atol=0)
    torch.testing.assert_close(tmax, want_tmax, rtol=0, atol=0)
    # a boolean frozen mask and a Python scale give the same update
    new_b, _ = e3cs_update_kernel_call(*rows[:4], rows[4] > 0, float(scale), tile=tile)
    torch.testing.assert_close(new_b, want_new, rtol=0, atol=0)
    torch.testing.assert_close(ops.e3cs_update_tiled(*rows, sc, tile=tile),
                               ref.e3cs_update_tiled_ref(*rows, sc), rtol=0, atol=0)

"""The threefry kernel (``csrc/threefry.cu``) against its plain version on
the card, and the JAX key stream's runner on the card against the same
runner on the CPU.  Bits, sort keys, uniforms, key pairs and the in-place
advance are equal; Gumbel rows within ``NOISE_ATOL`` (``logf`` against
ATen's ``log``), normal rows within ``NORMAL_ATOL`` (CUDA's ``log1pf``
against ATen's ``log1p``, two float32 ulps at the largest normal).  The
rows entry (J Gumbel rows under J keys) is held to ``threefry_rows_ref`` the
same way, and the fused ``categorical`` to ``categorical_ref`` exactly, float32
and bfloat16, with exact ties, ``-inf`` rows and NaNs.  A horizon from the same JAX key carries out the same key
and selects the same cohorts (no round of these has a client within
``NOISE_ATOL`` of its k-th score).  JAX's original (non-partitionable)
layout of every entry is held to its plain version the same ways, whole
draws and blocks of them, odd and even, and a horizon in that mode on the
card to the CPU's.

This file imports no JAX: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_prng_cuda.py`` on the card.  Without a card every test
skips.
"""
import pytest
import torch

from repro_torch.configs import FLConfig
from repro_torch.core import prng
from repro_torch.core.volatility import CompletionLag, make_volatility, paper_success_rates
from repro_torch.engine import RoundProgram
from repro_torch.engine.round_program import JaxStream
from repro_torch.kernels import launch_counts, threefry, threefry_categorical, threefry_rows
from repro_torch.kernels.ref import NORMAL_LO, categorical_ref, threefry_ref, threefry_rows_ref

NOISE_ATOL = 2e-6
NORMAL_ATOL = 1e-6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the threefry kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 3, 1000, 65537, 1_000_003])
@pytest.mark.parametrize("mode", ["keys", "bits", "sortkey", "uniform", "gumbel", "normal"])
def test_threefry_kernel_equals_its_plain_version(dev, mode, n):
    key = prng.PRNGKey(2024, dev).data
    for path, offset in (((), 0), ((5,), 7), ((1, 2**33 + 1, 3, 4), 2**32 - 3)):
        got = threefry(key, path, offset, n, mode, 1e-7 if mode == "uniform" else 0.0, 1.0)
        want = threefry_ref(key, path, offset, n, mode, 1e-7 if mode == "uniform" else 0.0, 1.0)
        if mode in ("gumbel", "normal"):
            assert float((got - want).abs().max()) <= (NOISE_ATOL if mode == "gumbel" else NORMAL_ATOL)
        else:
            assert torch.equal(got, want), (mode, n, path)


@pytest.mark.parametrize("J,n", [(1, 1), (3, 1000), (8, 100_000), (5, 65_537)])
def test_threefry_rows_equal_their_plain_version(dev, J, n):
    keys = prng.split_data(prng.PRNGKey(77, dev), J).data
    for path in ((3,), (1, 2**33 + 1, 3, 4)):
        got = threefry_rows(keys, path, n)
        want = threefry_rows_ref(keys, path, n)
        assert got.shape == (J, n)
        assert float((got - want).abs().max()) <= NOISE_ATOL
        for j in range(J):  # row j is the single-key draw under keys[j]
            one = threefry(keys[j].contiguous(), path, 0, n, "gumbel")
            assert torch.equal(got[j], one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,V", [(1, 7), (3, 5000), (4, 256_000), (2, 4096 + 1)])
def test_categorical_kernel_equals_its_plain_version(dev, dtype, B, V):
    key = prng.PRNGKey(5, dev).data
    gen = torch.Generator(device=dev).manual_seed(B * V)
    logits = (torch.randn((B, V), generator=gen, device=dev) * 4).to(dtype)
    cases = [logits, torch.zeros_like(logits), torch.full_like(logits, float("-inf"))]
    spiky = logits.clone()
    spiky[:, [0, V - 1]] = 1e4
    cases.append(spiky)
    nan = logits.clone()
    nan[:, V // 2] = float("nan")
    cases.append(nan)
    before = launch_counts()["threefry.categorical"]
    for x in cases:
        for path in ((), (7,), (1, 2, 3, 2**40 + 9)):
            got, want = threefry_categorical(key, path, x), categorical_ref(key, path, x)
            assert got.dtype == torch.int32 and torch.equal(got, want), (dtype, B, V, path)
    assert launch_counts()["threefry.categorical"] == before + 3 * len(cases)


def test_in_place_advance_and_launch_count(dev):
    key = prng.PRNGKey(9, dev).data
    want = threefry_ref(key, (), 0, 1, "keys").view(2)
    before = launch_counts()
    threefry(key, (), 0, 1, "keys", out=key.view(1, 2))
    after = launch_counts()
    assert torch.equal(key, want) and after["threefry.keys"] == before["threefry.keys"] + 1
    assert all(after[n] == c for n, c in before.items() if n != "threefry.keys")  # a count a mode
    threefry_rows(prng.split_data(prng.PRNGKey(1, dev), 2).data, (0,), 10)
    assert launch_counts()["threefry.rows"] == after["threefry.rows"] + 1
    with pytest.raises(ValueError):
        threefry(key, (), 0, 2, "bits", out=key)


@pytest.mark.parametrize("S", [None, 2], ids=["sync", "S2"])
def test_a_jax_key_horizon_on_the_card_equals_the_cpu(dev, S):
    K, k, T = 4096, 64, 6
    out = {}
    for d in ("cpu", dev):
        rho = paper_success_rates(K)
        vol = make_volatility("bernoulli", rho, device=d)
        if S is not None:
            vol = CompletionLag(vol, max_lag=S)
        fl = FLConfig(K=K, k=k, rounds=T, allocator="bisect")
        pm = RoundProgram(fl=fl, vol=vol, rho=rho, staleness=S, fused=True, device=d)
        run, s0 = pm.build_runner(outputs="full", carry_key=True)
        res = run(s0, prng.PRNGKey(4, d), *(() if S is None else (pm.init_rings(),)))
        out[str(d)] = (res[1].data.cpu(), res[2 if S is None else 3].cpu())
    (k_cpu, m_cpu), (k_dev, m_dev) = out["cpu"], out[str(dev)]
    assert torch.equal(k_cpu, k_dev)
    assert torch.equal(m_cpu, m_dev)


# -- the original layout (jax_threefry_partitionable=False) -------------------

@pytest.mark.parametrize("n", [1, 2, 3, 1000, 65537, 1_000_003])
@pytest.mark.parametrize("mode", ["keys", "bits", "sortkey", "uniform", "gumbel", "normal"])
def test_original_layout_equals_its_plain_version(dev, mode, n):
    key = prng.PRNGKey(2024, dev).data
    lo = 1e-7 if mode == "uniform" else 0.0
    for path in ((), (5,), (1, 2**33 + 1, 3, 4)):
        for offset, cnt in ((0, n), (n // 4, (n + 1) // 2), (n - 1, 1), (n // 2, n - n // 2)):
            got = threefry(key, path, offset, cnt, mode, lo, 1.0, total=n)
            want = threefry_ref(key, path, offset, cnt, mode, lo, 1.0, total=n)
            if mode in ("gumbel", "normal"):
                assert float((got - want).abs().max()) <= (NOISE_ATOL if mode == "gumbel" else NORMAL_ATOL)
            else:
                assert torch.equal(got, want), (mode, n, path, offset, cnt)


@pytest.mark.parametrize("J,n", [(1, 1), (3, 999), (8, 100_000), (5, 65_537)])
def test_original_rows_equal_their_plain_version(dev, J, n):
    keys = prng.split_data(prng.PRNGKey(77, dev, partitionable=False), J).data
    for path in ((3,), (1, 2**33 + 1, 3, 4)):
        got = threefry_rows(keys, path, n, original=True)
        assert float((got - threefry_rows_ref(keys, path, n, original=True)).abs().max()) <= NOISE_ATOL
        for j in range(J):  # row j is the single-key draw of n under keys[j]
            assert torch.equal(got[j], threefry(keys[j].contiguous(), path, 0, n, "gumbel", total=n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,V", [(1, 1), (1, 7), (3, 5001), (4, 256_000)])
def test_original_categorical_equals_its_plain_version(dev, dtype, B, V):
    key = prng.PRNGKey(5, dev).data
    gen = torch.Generator(device=dev).manual_seed(B * V)
    logits = (torch.randn((B, V), generator=gen, device=dev) * 4).to(dtype)
    before = launch_counts()["threefry.original.categorical"]
    for x in (logits, torch.zeros_like(logits)):
        for path in ((), (1, 2, 3, 2**40 + 9)):
            got = threefry_categorical(key, path, x, original=True)
            assert torch.equal(got, categorical_ref(key, path, x, original=True)), (dtype, B, V, path)
    assert launch_counts()["threefry.original.categorical"] == before + 4


def test_original_stream_advance_and_launch_counts(dev):
    """A carried original-mode key (``JaxStream``): a round's ``split(key,
    num)`` in one launch, then the key advances to its first key (a copy)."""
    for num in (2, 3, 4):
        stream = JaxStream(prng.PRNGKey(9, dev, partitionable=False), dev, num)
        for _ in range(2):
            want = threefry_ref(stream.key, (), 0, num, "keys", total=num)
            before = launch_counts()
            keys = torch.stack([k.data for k in stream.round_keys()])
            stream.advance()
            after = launch_counts()
            assert torch.equal(keys, want) and torch.equal(stream.key, want[0])
            assert after["threefry.original.keys"] == before["threefry.original.keys"] + 1
            assert all(after[n] == c for n, c in before.items() if n != "threefry.original.keys")
    key = prng.PRNGKey(9, dev).data
    with pytest.raises(ValueError, match="partitionable layout"):  # the original layout never writes its key
        threefry(key, (), 0, 1, "keys", out=key.view(1, 2), total=2)


@pytest.mark.parametrize("S", [None, 2], ids=["sync", "S2"])
def test_an_original_mode_horizon_on_the_card_equals_the_cpu(dev, S):
    K, k, T = 4096, 64, 6
    out = {}
    for d in ("cpu", dev):
        rho = paper_success_rates(K)
        vol = make_volatility("bernoulli", rho, device=d)
        if S is not None:
            vol = CompletionLag(vol, max_lag=S)
        pm = RoundProgram(fl=FLConfig(K=K, k=k, rounds=T, allocator="bisect"), vol=vol, rho=rho, staleness=S,
                          fused=True, device=d)
        run, s0 = pm.build_runner(outputs="full", carry_key=True)
        res = run(s0, prng.PRNGKey(4, d, partitionable=False), *(() if S is None else (pm.init_rings(),)))
        assert not res[1].partitionable
        out[str(d)] = (res[1].data.cpu(), res[2 if S is None else 3].cpu())
    (k_cpu, m_cpu), (k_dev, m_dev) = out["cpu"], out[str(dev)]
    assert torch.equal(k_cpu, k_dev)
    assert torch.equal(m_cpu, m_dev)


@pytest.mark.parametrize("total", [2**32 - 1, 2**32 + 5, 2 * (2**32 - 1) + 7])
@pytest.mark.parametrize("mode", ["bits", "uniform", "gumbel", "normal"])
def test_a_blocked_original_draw_equals_its_plain_version(dev, mode, total):
    """An original-layout draw of 2**32 - 1 words or more (JAX's blocks
    under split keys), in launches of a few words: the first, around a full
    block's padded last pair (its halves' boundary), across each block
    boundary (a launch spanning two blocks) and the rem block's."""
    key = prng.PRNGKey(77, dev).data
    M, H = 2**32 - 1, 2**31
    lo_val = NORMAL_LO if mode == "normal" else 0.0
    for lo, hi in ((0, 9), (H - 5, H + 4), (M - 6, min(M + 6, total)), (total - 7, total), (M - 3, M + 3)):
        lo, hi = max(0, min(lo, total)), min(hi, total)
        got = threefry(key, (5,), lo, hi - lo, mode, lo_val, 1.0, total=total)
        want = threefry_ref(key, (5,), lo, hi - lo, mode, lo_val, 1.0, total=total)
        atol = {"gumbel": NOISE_ATOL, "normal": NORMAL_ATOL}.get(mode, 0.0)
        assert torch.allclose(got, want, rtol=0, atol=atol) if atol else torch.equal(got, want), (lo, hi)


# -- the redesigned rows and categorical kernels: every width, edges, replays --


def _unaligned(shape, dtype, dev):
    """A contiguous tensor of ``shape`` whose data starts one element past a
    16-byte boundary."""
    n = 1
    for d in shape:
        n *= d
    return torch.empty(n + 1, dtype=dtype, device=dev)[1:].view(shape)


@pytest.mark.parametrize("original", [False, True], ids=["partitionable", "original"])
@pytest.mark.parametrize("J", [1, 8, 64])
def test_rows_at_every_width_equal_their_plain_version(dev, J, original):
    keys = prng.split_data(prng.PRNGKey(J, dev, partitionable=not original), J).data
    for n in (1, 3, 100_000, 100_001):
        want = threefry_rows_ref(keys, (3,), n, original=original)
        got = threefry_rows(keys, (3,), n, original=original)
        assert float((got - want).abs().max()) <= NOISE_ATOL, (J, n)
        off = threefry_rows(keys, (3,), n, out=_unaligned((J, n), torch.float32, dev), original=original)
        assert torch.equal(off, got), (J, n)  # rows off 16-byte alignment store the same values
        for j in (0, J - 1):  # a row is the single-key draw under its key
            one = threefry(keys[j].contiguous(), (3,), 0, n, "gumbel", total=n if original else 0)
            assert torch.equal(got[j], one), (J, n, j)


@pytest.mark.parametrize("original", [False, True], ids=["partitionable", "original"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 4, 133, 300])
def test_categorical_at_every_width_equals_its_plain_version(dev, B, dtype, original):
    key = prng.PRNGKey(11, dev, partitionable=not original).data
    gen = torch.Generator(device=dev).manual_seed(B)
    for V in (1, 7, 255_999, 256_000, 262_147):
        logits = (torch.randn((B, V), generator=gen, device=dev) * 3).to(dtype)
        want = categorical_ref(key, (4,), logits, original=original)
        assert torch.equal(threefry_categorical(key, (4,), logits, original=original), want), (B, V)
        off = _unaligned((B, V), dtype, dev).copy_(logits)  # logits off 16-byte alignment
        assert torch.equal(threefry_categorical(key, (4,), off, original=original), want), (B, V)


def _edge_logits(dtype, dev, V=1000):
    """Rows whose argmax JAX's rules decide: all -inf (0), +inf twice (the
    lower), NaN twice after +inf (the first NaN), a tie of two values the
    noise cannot move (the lower), NaN only at the end (the last)."""
    lg = torch.randn((5, V), device=dev)
    lg[0] = float("-inf")
    lg[1, [5, 3]] = float("inf")
    lg[2, 1], lg[2, [7, 2]] = float("inf"), float("nan")
    lg[3, [9, 4]] = 1e30
    lg[4, V - 1] = float("nan")
    return lg.to(dtype), [0, 3, 2, 4, V - 1]


@pytest.mark.parametrize("original", [False, True], ids=["partitionable", "original"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_categorical_takes_nan_inf_and_ties_as_jax(dev, dtype, original):
    key = prng.PRNGKey(3, dev).data
    logits, want = _edge_logits(dtype, dev)
    for x in (logits, _unaligned(logits.shape, dtype, dev).copy_(logits)):
        got = threefry_categorical(key, (), x, original=original)
        assert got.tolist() == want
        assert torch.equal(got, categorical_ref(key, (), x, original=original))


@pytest.mark.parametrize("original", [False, True], ids=["partitionable", "original"])
def test_a_replayed_graph_of_categorical_and_rows_gives_the_same_output(dev, original):
    """The kernel's cross-block scratch is left reset at the end of every
    launch: two launches in one captured graph, replayed twice, each give
    the plain version's argmax."""
    key = prng.PRNGKey(8, dev).data
    keys = prng.split_data(prng.PRNGKey(9, dev), 8).data
    gen = torch.Generator(device=dev).manual_seed(8)
    logits = (torch.randn((4, 256_000), generator=gen, device=dev) * 3).to(torch.bfloat16)
    rows = torch.empty((8, 100_001), device=dev)
    outs = []
    threefry_categorical(key, (1,), logits, original=original)  # warm up outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs.append(threefry_categorical(key, (1,), logits, original=original))
        outs.append(threefry_categorical(key, (2,), logits, original=original))
        threefry_rows(keys, (3,), 100_001, out=rows, original=original)
    want = [categorical_ref(key, (p,), logits, original=original) for p in (1, 2)]
    want_rows = threefry_rows(keys, (3,), 100_001, original=original)
    for _ in range(2):
        for o in outs:
            o.fill_(-1)
        rows.fill_(0.0)
        g.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(outs, want))
        assert torch.equal(rows, want_rows)

"""A numpy model of the radix select that every top-k kernel of the port
runs (``src/repro_torch/kernels/csrc/radix_topk.cuh``), held exactly against
``jax.lax.top_k`` and the plain version on adversarial inputs.

The model takes the digit width, bin count, pass count and buffer capacity
from the constants the wrapper module states to the kernel, and runs the
kernel's launches in order: pass 0 counts the first digit of every key; pass
j reads S_{j-1} (the row, the buffer the previous pass wrote, or the row
filtered again when S_{j-1} overflowed the buffer), gives an output slot to
each key above the chosen digit and counts (and buffers, when they fit) the
keys in the chosen bin; the last CTA's threshold step fixes the digit and
ends the select when the bin holds exactly the keys still needed; the gather
takes the chosen bin's keys at or above the k-th; the rank orders the k keys.
Small buffers make the overflow path run at small K.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.gumbel_topk import CAND_CAP, DIGIT_BITS, LAUNCHES, N_BINS, N_PASSES


def make_keys(scores):
    """The kernel's 64-bit keys: monotone float bits, then the complemented
    index, so unsigned key order is ``lax.top_k`` order."""
    u = np.asarray(scores, np.float32).view(np.uint32)
    mono = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint64)
    idx = np.arange(len(u), dtype=np.uint64)
    return (mono << np.uint64(32)) | (~idx & np.uint64(0xFFFFFFFF))


def key_value_index(keys):
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    u = np.where(hi & np.uint32(0x80000000), hi & np.uint32(0x7FFFFFFF), ~hi)
    return u.view(np.float32), (~keys & np.uint64(0xFFFFFFFF)).astype(np.int32)


def shift(j):
    return max(64 - DIGIT_BITS * (j + 1), 0)


def digit(keys, j):
    width = 64 - DIGIT_BITS * j - shift(j)
    return ((keys >> np.uint64(shift(j))) & np.uint64((1 << width) - 1)).astype(np.int64)


def radix_select(scores, k, cap=CAND_CAP):
    """The kernel's launches on ``scores``: ``(vals, idx, trace)``.
    ``trace`` counts the launches, the passes that did work and the passes
    that read the row."""
    keys = make_keys(scores)
    K = len(keys)
    cap = min(cap, K)
    prefix, needed, done = np.uint64(0), k, 0
    count, bufs, out = [], [None, None], []
    trace = {"launches": 1, "passes": 0, "row_reads": 0, "overflows": 0}  # the memset

    def s_in(j):
        """S_{j-1}, as pass j reads it."""
        if j >= 2 and count[j - 2] <= cap:
            return bufs[(j - 1) & 1]
        trace["row_reads"] += 1
        if j < 2:
            return keys
        return keys[((keys ^ prefix) >> np.uint64(shift(j - 2))) == 0]

    for j in range(N_PASSES):
        trace["launches"] += 1
        if j > 0 and done:
            continue
        trace["passes"] += 1
        if j == 0:
            trace["row_reads"] += 1
            members = keys
        else:
            src = s_in(j)
            hi, ph = src >> np.uint64(shift(j - 1)), prefix >> np.uint64(shift(j - 1))
            out.append(src[hi > ph])
            members = src[hi == ph]
            if count[j - 1] <= cap:
                assert len(members) <= cap
                bufs[j & 1] = members
            else:
                trace["overflows"] += 1
        hist = np.bincount(digit(members, j), minlength=N_BINS)
        assert len(hist) == N_BINS
        # the last CTA's threshold step: the chosen bin from the top
        above = np.concatenate([[0], np.cumsum(hist[::-1])])
        b = N_BINS - 1 - int(np.searchsorted(above[1:], needed))
        needed -= int(above[N_BINS - 1 - b])
        prefix |= np.uint64(b) << np.uint64(shift(j))
        count.append(int(hist[b]))
        if hist[b] == needed:
            done = j + 1
    assert done, "the last pass resolves every bit"
    trace["launches"] += 1  # the gather
    d = done - 1
    src = s_in(done)
    out.append(src[(src >> np.uint64(shift(d))) >= (prefix >> np.uint64(shift(d)))])
    trace["launches"] += 1  # the rank
    got = np.concatenate(out)
    assert len(got) == k and len(np.unique(got)) == k
    vals, idx = key_value_index(np.sort(got)[::-1])
    return vals, idx, trace


def adversarial(case, K, k, seed=0):
    """Scores of one adversarial case (float32)."""
    rng = np.random.default_rng(seed)
    if case == "equal":  # the digits run on into the index word
        return np.full(K, 0.75, np.float32)
    if case == "few_positive":  # fewer than k positive p: a -inf fill at the lowest indices
        p = np.zeros(K, np.float32)
        p[rng.permutation(K)[: k // 2]] = 0.01
        u = rng.random(K).astype(np.float32)
        pt, ut = torch.from_numpy(p), torch.from_numpy(u)
        return ref.fused_gumbel_scores(pt, ut).numpy()
    if case == "binade":  # one binade: the chosen bin of pass 0 overflows the buffer
        return rng.uniform(1.0, 2.0, K).astype(np.float32)
    if case == "ties":  # a few distinct values, many copies each
        return rng.choice(np.array([-1.5, 0.0, 2.25, 7.0], np.float32), K)
    p = rng.gamma(1.0, 1.0, K).astype(np.float32)  # Gumbel-perturbed allocation
    p = p / p.sum() * k
    return (np.log(np.maximum(p, np.float32(1e-20))) + rng.gumbel(size=K)).astype(np.float32)


CASES = [
    ("equal", 3000, 100, 64),
    ("equal", 3000, 100, CAND_CAP),
    ("few_positive", 3000, 100, 64),
    ("binade", 5000, 100, 64),
    ("binade", 5000, 100, CAND_CAP),
    ("ties", 4000, 777, 64),
    ("gumbel", 20000, 1, 64),
    ("gumbel", 20000, 1000, 64),
    ("gumbel", 20000, 1000, CAND_CAP),
    ("gumbel", 3000, 2048, 64),
    ("gumbel", 2048, 2048, 64),  # K = k
    ("equal", 2048, 2048, 64),
    ("gumbel", 100_003, 1000, 512),
]


@pytest.mark.parametrize("case,K,k,cap", CASES, ids=[f"{c}-K{K}-k{k}-cap{cap}" for c, K, k, cap in CASES])
def test_radix_select_model_is_exact(case, K, k, cap):
    scores = adversarial(case, K, k, seed=K + k)
    vals, idx, trace = radix_select(scores, k, cap=cap)
    jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
    np.testing.assert_array_equal(idx, np.asarray(ji))
    np.testing.assert_array_equal(vals, np.asarray(jv))
    rv, ri = ref.gumbel_topk_kernel_ref(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(idx, ri.numpy())
    np.testing.assert_array_equal(vals, rv.numpy())
    assert trace["launches"] == LAUNCHES
    assert 1 <= trace["passes"] <= N_PASSES


def test_model_reaches_every_path():
    """Equal scores need every pass; a binade overflows a small buffer and
    is read from the row again; Gumbel-perturbed scores end in 2-3 passes
    from the buffer."""
    _, _, t = radix_select(adversarial("equal", 3000, 100), 100, cap=64)
    assert t["passes"] == N_PASSES
    _, _, t = radix_select(adversarial("binade", 5000, 100), 100, cap=64)
    assert t["overflows"] >= 1 and t["row_reads"] >= 3
    _, _, t = radix_select(adversarial("gumbel", 100_003, 1000), 1000)
    assert t["passes"] <= 3 and t["overflows"] == 0 and t["row_reads"] == 2


@pytest.mark.parametrize("K,k", [(3000, 100), (20000, 1000), (5000, 2048)])
def test_launches_depend_on_K_and_k_alone(K, k):
    """The launch sequence has one length for given (K, k), whatever the
    data, while the passes that do work vary with it."""
    traces = [radix_select(adversarial(c, K, k, seed=1), k, cap=64)[2] for c in ("equal", "binade", "gumbel", "ties")]
    assert {t["launches"] for t in traces} == {LAUNCHES}
    assert len({t["passes"] for t in traces}) > 1


def test_model_matches_fused_plain_version_with_few_positive():
    """The -inf fill: fewer than k positive p end on the lowest masked
    indices, as the fused kernel's plain version gives."""
    K, k = 3000, 100
    rng = np.random.default_rng(7)
    p = np.zeros(K, np.float32)
    p[rng.permutation(K)[:30]] = 0.2
    u = rng.random(K).astype(np.float32)
    pt, ut = torch.from_numpy(p), torch.from_numpy(u)
    vals, idx, _ = radix_select(ref.fused_gumbel_scores(pt, ut).numpy(), k, cap=16)
    rv, ri = ref.fused_gumbel_topk_kernel_ref(pt, ut, k)
    np.testing.assert_array_equal(idx, ri.numpy())
    np.testing.assert_array_equal(vals, rv.numpy())
    assert np.isinf(vals[30:]).all() and idx[30:].tolist() == np.flatnonzero(p <= 0)[:70].tolist()

"""The port's key stream in JAX's original threefry mode
(``jax_threefry_partitionable=False``): every ``core.prng`` entry under
``prng.threefry_partitionable(False)`` against ``jax.random`` inside
``jax.threefry_partitionable(False)`` (restored after each use: the xdist
worker runs other files after this one), a slot engine's mode through its
checkpoint, then entry points that thread a key's mode through their keys,
reusing the partitionable mode's tests of them under both flags (the
goldens' cells are ``tests/test_torch_goldens.py``).

Tolerances, each the partitionable mode's (``tests/test_torch_prng.py``,
``tests/test_torch_prng_dists.py``): keys, bits, uniforms, Bernoulli draws,
permutations, ``randint`` and ``categorical`` exact; Gumbel and exponential
rows within ``NOISE_ATOL`` (one ulp of ``log``: ATen's against XLA's);
``normal`` within ``NORMAL_ULPS`` float32 ulps (ATen's ``log1p``, not XLA's).
"""
import contextlib

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.engine.round_program import JaxStream
from repro_torch.kernels import ref
import test_torch_fl_keys as fl_keys
from test_torch_fl_keys import data  # noqa: F401
from test_torch_fl_keys import test_server_on_jax_keys_equals_jax as server_case
from test_torch_prng_dists import test_model_init_equals_jax as model_init_case
from test_torch_seeded_drivers import test_record_traces_equal_jax as record_case
from test_torch_seeded_drivers import test_run_service_compiled_counts_equal_jax as compiled_case
from test_torch_seeded_drivers import test_serve_main_tokens_equal_jax as serve_case

NOISE_ATOL = 2e-6
NORMAL_ULPS = 3
DEV = "cpu"


@contextlib.contextmanager
def original():
    """Both packages in the original mode, each flag restored after."""
    with jax.threefry_partitionable(False), prng.threefry_partitionable(False):
        yield
    assert jax.config.jax_threefry_partitionable and prng.default_partitionable()


def _words(key):
    return np.asarray(jax.random.key_data(key) if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) else key).view(
        np.int32)


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, DEV)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


# -- the mode itself ----------------------------------------------------------

def test_default_stays_partitionable_and_keys_keep_their_mode():
    assert prng.default_partitionable() and prng.PRNGKey(0, DEV).partitionable
    with prng.threefry_partitionable(False):
        key = prng.PRNGKey(0, DEV)
        with prng.threefry_partitionable(True):
            assert prng.PRNGKey(0, DEV).partitionable and not key.partitionable
        assert not prng.default_partitionable()
    assert prng.default_partitionable()
    with pytest.raises(RuntimeError), prng.threefry_partitionable(False):
        raise RuntimeError("the flag is restored on the way out")
    assert prng.default_partitionable()
    # a key keeps its mode through split, fold_in, derive and deep paths, whatever the default
    assert not key.partitionable
    subs = prng.split(key, 3)
    derived = [prng.fold_in(subs[1], 5), prng.derive(key, (4, (1, 2), 7)), prng.split(subs[0])[1]]
    for d in range(6):
        derived.append(prng.fold_in(derived[-1], d))
    assert all(not k.partitionable for k in subs + tuple(derived))
    part = prng.PRNGKey(0, DEV, partitionable=True)
    assert all(k.partitionable for k in prng.split(part, 3) + (prng.fold_in(part, 1),))
    # the two modes' splits part: partitionable split(key, n)[i] is fold_in(key, i), the original's is not
    np.testing.assert_array_equal(prng.key_data(prng.split(part, 3)[1]).numpy(),
                                  prng.key_data(prng.fold_in(part, 1)).numpy())
    assert not torch.equal(prng.key_data(subs[1]), prng.key_data(prng.fold_in(key, 1)))


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1, -1, 2**32 - 1, 2**40 + 5])
def test_prng_key(seed):
    with original():
        np.testing.assert_array_equal(prng.PRNGKey(seed, DEV).data.numpy(), _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_split_and_split_data(n):
    with original():
        jk, pk = _keys(7)
        want = _words(jax.random.split(jk, n))
        got = [prng.key_data(k).numpy() for k in prng.split(pk, n)]
        np.testing.assert_array_equal(np.stack(got), want)
        folded = prng.fold_in(pk, 9)  # a key with a path: the split hashes it in first
        keys = prng.split_data(folded, n)
        assert not keys.partitionable
        np.testing.assert_array_equal(keys.data.numpy(), _words(jax.random.split(jax.random.fold_in(jk, 9), n)))


@pytest.mark.parametrize("num", [1, 2, 3, 4])
def test_advance(num):
    """A carried key (``JaxStream``): JAX's ``key, *subs = split(key,
    num)`` round after round."""
    with original():
        jk, pk = _keys(11)
        stream = JaxStream(pk, DEV, num)
        for _ in range(3):
            jsplit = jax.random.split(jk, num)
            np.testing.assert_array_equal(np.stack([k.data.numpy() for k in stream.round_keys()]), _words(jsplit))
            stream.advance()
            jk = jsplit[0]
            np.testing.assert_array_equal(stream.key.numpy(), _words(jk))
            assert not stream.get_state().partitionable


def test_fold_in_and_deep_paths():
    with original():
        jk, pk = _keys(11)
        for d in (0, 1, 5, 2**31 + 3, 2**32 - 1):
            np.testing.assert_array_equal(prng.key_data(prng.fold_in(pk, d)).numpy(),
                                          _words(jax.random.fold_in(jk, d)))
        for d in range(7):  # past the kernel's four folds a launch
            jk, pk = jax.random.fold_in(jk, d), prng.fold_in(pk, d)
            _, jsub = jax.random.split(jk)
            np.testing.assert_array_equal(prng.uniform(prng.split(pk)[1], (9,)).numpy(),
                                          np.asarray(jax.random.uniform(jsub, (9,))))


SHAPES = [(), (1,), (2,), (7,), (3, 5), (70001,)]  # n = 1, even, odd, and past a CPU chunk


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_bernoulli_exact(shape):
    with original():
        jk, pk = _keys(5)
        np.testing.assert_array_equal(prng.random_bits(pk, shape).numpy(),
                                      np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
        np.testing.assert_array_equal(prng.uniform(pk, shape).numpy(), np.asarray(jax.random.uniform(jk, shape)))
        np.testing.assert_array_equal(prng.uniform(pk, shape, 1e-7, 1.0).numpy(),
                                      np.asarray(jax.random.uniform(jk, shape, jnp.float32, 1e-7, 1.0)))
        p = np.linspace(0.0, 1.0, int(np.prod(shape)), dtype=np.float32).reshape(shape)
        np.testing.assert_array_equal(prng.bernoulli(pk, torch.from_numpy(p)).numpy(),
                                      np.asarray(jax.random.bernoulli(jk, jnp.asarray(p))))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gumbel_and_exponential_within_atol(shape):
    with original():
        jk, pk = _keys(9)
        np.testing.assert_allclose(prng.gumbel(pk, shape).numpy(), np.asarray(jax.random.gumbel(jk, shape)),
                                   rtol=0, atol=NOISE_ATOL)
        np.testing.assert_allclose(prng.exponential(pk, shape).numpy(),
                                   np.asarray(jax.random.exponential(jk, shape)), rtol=0, atol=NOISE_ATOL)


@pytest.mark.parametrize("seed,shape", [(0, (4097,)), (7, (33, 64))])
def test_normal_whole_and_in_blocks(seed, shape):
    with original():
        jk, pk = _keys(seed)
        want = np.asarray(jax.random.normal(jk, shape))
        got = prng.normal(pk, shape)
        assert _ulps(got.numpy(), want).max() <= NORMAL_ULPS
        # the draw in blocks (an expert at a time): each block equals the whole draw's elements, bit for bit
        n, flat = int(np.prod(shape)), got.reshape(-1)
        for start, size in ((0, 100), (1000, 1000), (n // 2 - 7, 19), (n - 33, 33)):
            block = prng.normal(pk, (size,), start=start, total=n)
            np.testing.assert_array_equal(block.numpy(), flat[start:start + size].numpy())
        with pytest.raises(ValueError, match="total"):
            prng.normal(pk, (10,), start=5)


@pytest.mark.parametrize("n", [1, 2, 17, 256, 70001])
def test_permutation(n):
    with original():
        jk, pk = _keys(13)
        np.testing.assert_array_equal(prng.permutation(pk, n).numpy(), np.asarray(jax.random.permutation(jk, n)))


@pytest.mark.parametrize("dtype,lo,hi", [(torch.int8, -100, 120), (torch.int16, -7, 3000), (torch.int32, -7, 13),
                                         (torch.int32, -(2**31), 2**31 - 1)])
def test_randint_exact(dtype, lo, hi):
    jdt = {torch.int8: jnp.int8, torch.int16: jnp.int16, torch.int32: jnp.int32}[dtype]
    with original():
        jk, pk = _keys(21)
        for shape in ((1,), (1001,), (4, 5)):
            got = prng.randint(pk, shape, lo, hi, dtype)
            assert got.dtype == dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.randint(jk, shape, lo, hi, jdt)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_categorical_exact(dtype):
    """Rows of random logits (an odd count of values, so the draw's last
    word is padded), all-equal logits, two tied maxima and a 1-D row; a
    bfloat16 value is a byte of a word (four values a word)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(5, 3001)).astype(np.float32)
    logits[1] = 0.0
    logits[2, [17, 2900]] = 40.0
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    with original():
        for seed in range(2):
            jk, pk = _keys(seed)
            got = prng.categorical(pk, torch.from_numpy(logits).to(dtype))
            want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits).astype(jdt)))
            assert got.dtype == torch.int32 and got.shape == (5,)
            np.testing.assert_array_equal(got.numpy(), want)
            for V in (1, 2, 3, 7):
                row = logits[3, :V]
                one = prng.categorical(prng.fold_in(pk, 7), torch.from_numpy(row).to(dtype))
                np.testing.assert_array_equal(one.numpy(), np.asarray(jax.random.categorical(
                    jax.random.fold_in(jk, 7), jnp.asarray(row).astype(jdt))))


def test_bfloat16_noise_is_jax_bytes():
    """The bfloat16 Gumbel behind ``categorical``: value ``i`` from byte
    ``i % 4`` of word ``i // 4``, equal to JAX's bfloat16 ``gumbel``
    (exact: 128 values, each ``log`` rounded to bfloat16)."""
    with original():
        jk, pk = _keys(2)
        for n in (1, 5, 8, 4099):
            logits = torch.zeros((n, 1), dtype=torch.bfloat16)  # a row a value: the argmax is 0, the noise is read
            want = np.asarray(jax.random.gumbel(jk, (n,), jnp.bfloat16).astype(jnp.float32))
            m = -(-n // 4)
            words = ref.threefry_ref(pk.data, (), 0, m, "bits", total=m)
            bits8 = ((words[:, None] >> torch.arange(0, 32, 8, dtype=torch.int32)) & 0xFF).reshape(-1)[:n]
            np.testing.assert_array_equal(ref._gumbel_bf16(bits8).float().numpy(), want)
            assert torch.equal(prng.categorical(pk, logits), torch.zeros(n, dtype=torch.int32))


def test_rows_equal_jax_per_job_draws():
    """``rows(split_data(key, J), (t,), n)`` in the original mode: each row
    a draw of its own, odd and even n."""
    J, t = 6, 11
    with original():
        jk, pk = _keys(4)
        keys = prng.split_data(pk, J)
        jkeys = jax.random.split(jk, J)
        np.testing.assert_array_equal(keys.data.numpy(), _words(jkeys))
        for n in (1, 999, 1000):
            g = prng.rows(keys, (t,), n)
            jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(jax.random.fold_in(k, t), (n,)))(jkeys))
            assert g.shape == (J, n) and np.abs(g.numpy() - jg).max() <= NOISE_ATOL
    # the rows follow the keys' mode: the same words in the partitionable mode give other rows
    assert not torch.allclose(prng.rows(prng.Keys(keys.data, True), (t,), 1000), prng.rows(keys, (t,), 1000))


def test_draws_past_the_word_limit_raise():
    with original():
        key = prng.PRNGKey(0, DEV)
        with pytest.raises(ValueError, match="2\\*\\*32 - 1"):
            prng.split_data(key, 2**31)


# -- a draw of 2**32 - 1 words or more: JAX's blocks under split keys ----------

BLOCK = 2**32 - 1
H = 2**31  # a full block's half: its pair H - 1 is padded (word H - 1 its last first output)
# totals (one full block and no rem, one and a rem of 6, two and a rem of 7) and
# the words of each slice held to JAX's: the first, around the padded last pair
# of each full block, across each block boundary, and the rem block's
BLOCKED = {
    BLOCK: [(0, 8), (H - 5, H + 4), (BLOCK - 9, BLOCK)],
    2**32 + 5: [(0, 8), (H - 5, H + 4), (BLOCK - 6, BLOCK + 6)],
    2 * BLOCK + 7: [(BLOCK - 3, BLOCK + 3), (BLOCK + H - 4, BLOCK + H + 3), (2 * BLOCK - 4, 2 * BLOCK + 7)],
}


def _jax_blocked_words(jkey, total, lo, hi):
    """JAX's words ``lo .. hi - 1`` (uint32) of an original-mode draw of
    ``total`` words as ``_threefry_random_bits_original`` forms them, without
    the draw: the keys of ``threefry_split(key, (nblocks + 1,))``, and each
    word's counter pair in its block hashed by ``threefry_2x32`` under the
    block's key (a count of 2P values hashes the pairs (c[i], c[P + i]))."""
    from jax._src import prng as jprng

    nblocks, rem = divmod(total, BLOCK)
    keys = jprng.threefry_split(jkey, (nblocks + 1,))
    blk, local = np.divmod(np.arange(lo, hi, dtype=np.int64), BLOCK)
    out = np.empty(hi - lo, np.uint32)
    for b in np.unique(blk):
        sel, mb = blk == b, BLOCK if b < nblocks else rem
        h = (mb + 1) // 2
        w = local[sel]
        j = np.where(w < h, w, w - h)
        y = np.asarray(jprng.threefry_2x32(keys[b], jnp.asarray(np.concatenate([j, np.where(j + h < mb, j + h, 0)]),
                                                                  jnp.uint32)))
        out[sel] = np.where(w < h, y[: len(j)], y[len(j):])
    return out


@jax.jit
def _jax_unit(bits, minval, maxval):
    """``jax.random.uniform``'s float32 values from given 32-bit words
    (``jax._src.random._uniform`` after its ``_random_bits``)."""
    floats = lax.bitcast_convert_type(lax.shift_right_logical(bits, jnp.uint32(9)) | jnp.uint32(0x3F800000),
                                      jnp.float32) - jnp.float32(1)
    return lax.max(minval, floats * (maxval - minval) + minval)


def _jax_values(mode, words):
    """JAX's ``mode`` values of the words: ``bits`` as int32, ``uniform``,
    ``gumbel`` (mode ``"low"``) and ``normal`` as ``jax.random`` forms them."""
    bits = jnp.asarray(words, jnp.uint32)
    if mode == "bits":
        return words.view(np.int32)
    if mode == "uniform":
        return np.asarray(_jax_unit(bits, jnp.float32(0), jnp.float32(1)))
    if mode == "gumbel":
        tiny = jnp.float32(np.finfo(np.float32).tiny)
        return np.asarray(-jnp.log(-jnp.log(_jax_unit(bits, tiny, jnp.float32(1)))))
    lo = jnp.float32(np.nextafter(np.float32(-1), np.float32(0)))
    return np.asarray(jnp.float32(np.sqrt(2)) * lax.erf_inv(_jax_unit(bits, lo, jnp.float32(1))))


@pytest.mark.parametrize("total", list(BLOCKED), ids=lambda t: f"total={t}")
@pytest.mark.parametrize("mode", ["bits", "uniform", "gumbel", "normal"])
def test_blocked_draw_slices_equal_jax_words(mode, total):
    """Slices of an original-mode draw of 2**32 - 1 words or more (the
    port's plain version hashes only a slice's pairs) against JAX's blocked
    draw: bits and uniforms exact, Gumbel within ``NOISE_ATOL``, normal
    within ``NORMAL_ULPS``; ``normal``'s ``start``/``total`` blocks too."""
    with original():
        jk, pk = jax.random.fold_in(jax.random.PRNGKey(11), 3), prng.fold_in(prng.PRNGKey(11, DEV), 3)
        for lo, hi in BLOCKED[total]:
            want = _jax_values(mode, _jax_blocked_words(jk, total, lo, hi))
            got = ref.threefry_ref(pk.data, pk.path, lo, hi - lo, mode, ref.NORMAL_LO if mode == "normal" else 0.0,
                                   1.0, total=total).numpy()
            if mode in ("bits", "uniform"):
                np.testing.assert_array_equal(got, want)
            elif mode == "gumbel":
                np.testing.assert_allclose(got, want, rtol=0, atol=NOISE_ATOL)
            else:
                assert _ulps(got, want).max() <= NORMAL_ULPS
                np.testing.assert_array_equal(prng.normal(pk, (hi - lo,), start=lo, total=total).numpy(), got)


# -- a runner keeps its first key's mode ---------------------------------------

def test_runner_keeps_the_mode_of_its_first_key():
    from repro_torch.configs import FLConfig
    from repro_torch.core.volatility import make_volatility, paper_success_rates
    from repro_torch.engine import RoundProgram

    K = 64
    rho = paper_success_rates(K)
    pm = RoundProgram(fl=FLConfig(K=K, k=8, rounds=4, scheme="e3cs", quota_frac=0.5),
                      vol=make_volatility("bernoulli", rho, device=DEV), rho=rho, device=DEV)
    run, s0 = pm.build_runner()
    first = run(s0, prng.PRNGKey(1, DEV, partitionable=False))
    again = run(s0, prng.PRNGKey(1, DEV, partitionable=False))
    np.testing.assert_array_equal(first[1].numpy(), again[1].numpy())
    with pytest.raises(ValueError, match="threefry mode"):
        run(s0, prng.PRNGKey(1, DEV, partitionable=True))
    other, s1 = pm.build_runner()
    assert not torch.equal(other(s1, prng.PRNGKey(1, DEV, partitionable=True))[1], first[1])


# -- a serving engine keeps its mode through a checkpoint ----------------------

@pytest.mark.parametrize("staleness", [0, 2])
def test_an_original_mode_slot_engine_restores_in_its_mode(tmp_path, staleness):
    """A JAX-stream slot engine built in the original mode, saved and
    restored outside that block: its meta names the mode, and the restored
    engine ticks on with the cohorts of the engine that never stopped (a
    partitionable engine's differ)."""
    from repro_torch.serve import JobSpec, SlotEngine, load_server, protocol, save_server

    rng = np.random.default_rng(2)
    specs = [JobSpec(K=40, k=5, seed=3), JobSpec(K=24, k=4, seed=4)]
    feed = [[np.where(lag > staleness, protocol.DEAD_LAG, lag).astype(np.int32)
             for lag in (rng.integers(0, staleness + 2, s.K) for s in specs)] for _ in range(8)]

    def fresh(partitionable):
        with prng.threefry_partitionable(partitionable):
            eng = SlotEngine(K_max=64, k_cap=8, staleness=staleness, buckets=(4,), device=DEV, stream="jax")
        return eng, [eng.admit(s) for s in specs]

    ref_eng, uids = fresh(False)
    want = [ref_eng.tick(list(zip(uids, f))) for f in feed]
    eng, _ = fresh(False)
    for f in feed[:4]:
        eng.tick(list(zip(uids, f)))
    assert eng.meta()["threefry_partitionable"] is False
    restored, step = load_server(save_server(str(tmp_path), eng, step=4), device=DEV)
    assert step == 4 and restored.meta() == eng.meta() and not restored.partitionable
    assert [restored.tick(list(zip(uids, f))) for f in feed[4:]] == want[4:]
    part, _ = fresh(True)
    assert part.meta()["threefry_partitionable"] is True
    assert [r[u]["cohort"] for r in (part.tick(list(zip(uids, f))) for f in feed) for u in uids] != \
        [r[u]["cohort"] for r in want for u in uids]


# -- entry points in the original mode (the partitionable mode's tests of them, under both flags) --

def test_model_init_equals_jax():
    """A stack's layers under ``split(rng, n)``, an MoE weight in blocks of
    its one draw."""
    with original():
        model_init_case("qwen3-moe-30b-a3b", None)


def test_record_trace_equals_jax():
    with original():
        record_case("markov")


def test_run_service_compiled_counts_equal_jax():
    with original():
        compiled_case(2)


def test_serve_main_tokens_equal_jax(capsys, monkeypatch):
    """Parameters, prompt (``randint``) and the decode chain's
    ``categorical`` keys, all in the original mode."""
    with original():
        serve_case(capsys, monkeypatch)


def test_fl_server_equals_jax(data, monkeypatch):  # noqa: F811
    """pow-d: ``split(key, 4)`` a round, the candidates from its fourth key
    and the model's rows from ``split(fold_in(k_round, 1))[0]``, over two
    rounds (the first carries the key into the second)."""
    monkeypatch.setattr(fl_keys, "ROUNDS", 2)
    with original():
        server_case(data, "pow_d", 0)

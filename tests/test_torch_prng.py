"""The port's twin of JAX's key stream (``repro_torch.core.prng``) against jax
0.9 (partitionable threefry), and round horizons run from a JAX key against
the JAX package's ``build_runner`` from the same key.

What is exact: keys, splits, fold-ins, bits, uniforms (also with a lower
end), Bernoulli draws and permutations; in a horizon the outcomes, lags,
counts and the key carried out.  Gumbel and exponential rows are within
``NOISE_ATOL`` (ATen's and XLA's ``log`` differ by at most one ulp; measured
9.5e-7 at 10^6 draws).  A cohort equals JAX's, or else every client that
differs scores within ``NOISE_ATOL`` of that round's k-th score in JAX
(``assert_cohorts``); the rounds after such a round are not compared.
Allocations and log-weights are within ``RTOL``/``ATOL`` (float32 sums in
another order).

The horizons run K = 256 clients: dense for every scheme and sampler, sync
and async, over Bernoulli, Markov, deadline and three scenario models; on a
one-rank gloo mesh in this process; and on two spawned gloo ranks
(``torch_prng_ranks``, no JAX), where every row comes from the key JAX's
shard draws it from, the regional outage's chain included.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.scenarios as J
from repro.configs import FLConfig as JFLConfig
from repro.core.volatility import CompletionLag as JCompletionLag
from repro.core.volatility import make_volatility as jmake_volatility
from repro.core.volatility import paper_success_rates as jpaper_success_rates
from repro.engine.round_program import RoundProgram as JRoundProgram
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro_torch.core import prng
from test_torch_mesh import mesh1, spawn_groups  # noqa: F401
from torch_prng_ranks import SEED, T, horizon_rank, horizon_ranks, port_program

NOISE_ATOL = 2e-6
RTOL, ATOL = 1e-5, 1e-5
K, k = 256, 16


def _words(key):
    return np.asarray(jax.random.key_data(key) if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) else key).view(
        np.int32)


# -- the twin against jax.random ----------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1, -1, 2**32 - 1, 2**40 + 5])
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed, "cpu").data.numpy(), _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_split(n):
    jk, pk = jax.random.PRNGKey(7), prng.PRNGKey(7, "cpu")
    for a, b in zip(prng.split(pk, n), jax.random.split(jk, n)):
        np.testing.assert_array_equal(prng.key_data(a).numpy(), _words(b))


def test_fold_in_and_deep_paths():
    jk, pk = jax.random.PRNGKey(11), prng.PRNGKey(11, "cpu")
    for d in (0, 1, 5, 2**31 + 3, 2**32 - 1):
        np.testing.assert_array_equal(prng.key_data(prng.fold_in(pk, d)).numpy(), _words(jax.random.fold_in(jk, d)))
    for d in range(7):  # past the kernel's four folds a launch
        jk, pk = jax.random.fold_in(jk, d), prng.fold_in(pk, d)
        _, jsub = jax.random.split(jk)
        np.testing.assert_array_equal(prng.uniform(prng.split(pk)[1], (9,)).numpy(),
                                      np.asarray(jax.random.uniform(jsub, (9,))))


SHAPES = [(), (1,), (7,), (3, 5), (70001,)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_bernoulli_exact(shape):
    jk, pk = jax.random.PRNGKey(5), prng.PRNGKey(5, "cpu")
    np.testing.assert_array_equal(prng.random_bits(pk, shape).numpy(),
                                  np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    np.testing.assert_array_equal(prng.uniform(pk, shape).numpy(), np.asarray(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(prng.uniform(pk, shape, 1e-7, 1.0).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape, jnp.float32, 1e-7, 1.0)))
    np.testing.assert_array_equal(prng.uniform(pk, shape, -2.5, 3.0).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape, jnp.float32, -2.5, 3.0)))
    p = np.linspace(0.0, 1.0, int(np.prod(shape)), dtype=np.float32).reshape(shape)
    np.testing.assert_array_equal(prng.bernoulli(pk, torch.from_numpy(p)).numpy(),
                                  np.asarray(jax.random.bernoulli(jk, jnp.asarray(p))))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gumbel_and_exponential_within_atol(shape):
    jk, pk = jax.random.PRNGKey(9), prng.PRNGKey(9, "cpu")
    np.testing.assert_allclose(prng.gumbel(pk, shape).numpy(), np.asarray(jax.random.gumbel(jk, shape)), rtol=0,
                               atol=NOISE_ATOL)
    np.testing.assert_allclose(prng.exponential(pk, shape).numpy(), np.asarray(jax.random.exponential(jk, shape)),
                               rtol=0, atol=NOISE_ATOL)


@pytest.mark.parametrize("n", [1, 2, 17, 256, 70001])
def test_permutation(n):
    jk, pk = jax.random.PRNGKey(13), prng.PRNGKey(13, "cpu")
    np.testing.assert_array_equal(prng.permutation(pk, n).numpy(), np.asarray(jax.random.permutation(jk, n)))


# -- horizons from a JAX key --------------------------------------------------

def _jax_program(c):
    if c["scenario"] in (None, "markov", "deadline"):
        rho = jpaper_success_rates(K)
        vol = jmake_volatility(c["scenario"] or "bernoulli", rho, seed=SEED)
    else:
        vol, rho = J.make_scenario(c["scenario"], K, T, SEED)
    if c["staleness"] is not None:
        vol = JCompletionLag(vol, max_lag=c["staleness"])
    fl = JFLConfig(K=K, k=k, rounds=T, scheme=c["scheme"], sampler=c["sampler"], quota_frac=0.5,
                   allocator=c["allocator"])
    mesh = None if c["D"] is None else jmake_host_mesh(c["D"])
    return JRoundProgram(fl=fl, vol=vol, rho=rho, staleness=c["staleness"], alpha=0.5, mesh=mesh, fused=c["fused"])


def _case(name, scheme="e3cs", sampler="plackett_luce", staleness=None, scenario=None, D=None, fused=False):
    return dict(name=name, scheme=scheme, sampler=sampler, staleness=staleness, scenario=scenario, D=D, fused=fused,
                allocator="bisect" if D is not None or fused else "sort", K=K, k=k)


SCHEMES = [("e3cs", "plackett_luce"), ("e3cs", "systematic"), ("random", "plackett_luce"),
           ("fedcs", "plackett_luce"), ("pow_d", "plackett_luce"), ("ucb", "plackett_luce")]
DENSE = (
    [_case(f"{s}-{sm}-{'sync' if S is None else 'async'}", s, sm, S) for s, sm in SCHEMES for S in (None, 2)]
    + [_case(f"e3cs-{sc}", scenario=sc) for sc in ("markov", "deadline", "diurnal", "regional_outage", "flash_crowd")]
    + [_case("e3cs-fused-sync", fused=True), _case("e3cs-fused-async", staleness=2, fused=True)]
)
MESH = [_case("e3cs-d1", D=1, fused=True), _case("e3cs-async-d1", D=1, staleness=2),
        _case("random-d1", "random", D=1), _case("e3cs-d2", D=2, fused=True), _case("e3cs-async-d2", D=2, staleness=2),
        _case("fedcs-d2", "fedcs", D=2), _case("pow_d-d2", "pow_d", D=2),
        _case("regional_outage-d2", D=2, scenario="regional_outage")]


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    c = {**{x["name"]: x for x in DENSE + MESH}}[name]
    jpm = _jax_program(c)
    run, s0 = jpm.build_runner(outputs="full", carry_key=True)
    xs = jnp.zeros((T, 0), jnp.float32)
    key = jax.random.PRNGKey(SEED)
    if c["staleness"] is None:
        st, key, *outs = run(s0, key, xs)
    else:
        st, key, _, *outs = run(s0, key, jpm.init_rings(), xs)
    return st, _words(key), [np.asarray(o) for o in outs]


def _jax_scores(c, t, p):
    """JAX's perturbed scores of round ``t`` (E3CS's Plackett-Luce draw),
    ``p`` its allocation, the Gumbel rows per shard side by side."""
    key = jax.random.PRNGKey(SEED)
    for _ in range(t + 1):
        key, k1, _ = jax.random.split(key, 3)
    if c["D"] is None or c["D"] == 1:
        g = np.asarray(jax.random.gumbel(k1, (p.shape[0],)))
    else:
        Ks = p.shape[0] // c["D"]
        g = np.concatenate([np.asarray(jax.random.gumbel(jax.random.fold_in(k1, d), (Ks,))) for d in range(c["D"])])
    return np.log(np.maximum(p, 1e-30)) + g


def assert_cohorts(c, masks, jmasks, jps):
    """Masks equal JAX's round by round, or else (E3CS's Plackett-Luce draw
    only) every client that differs lies within ``NOISE_ATOL`` of the
    round's k-th score in JAX; returns the rounds held equal."""
    for t in range(masks.shape[0]):
        if np.array_equal(masks[t], jmasks[t]):
            continue
        assert c["scheme"] == "e3cs" and c["sampler"] == "plackett_luce", f"round {t}: cohorts differ"
        s = _jax_scores(c, t, jps[t])
        kth = np.sort(s)[::-1][c["k"] - 1]
        diff = np.nonzero(masks[t] != jmasks[t])[0]
        assert np.all(np.abs(s[diff] - kth) <= NOISE_ATOL), (t, s[diff], kth)
        return t
    return masks.shape[0]


def _check(c, got, jst, jkey, jouts):
    sync = c["staleness"] is None
    masks, second, ps = got["masks"], got["second"], got["ps"]
    n = assert_cohorts(c, masks, jouts[0], jouts[2])
    np.testing.assert_array_equal(second[:n], jouts[1][:n])  # outcomes, or lags
    np.testing.assert_allclose(ps[:n], jouts[2][:n], rtol=RTOL, atol=ATOL)
    if not sync:
        np.testing.assert_array_equal(got["arrived"][:n], jouts[4][:n])
    np.testing.assert_array_equal(got["key"], jkey)
    if n == T:
        np.testing.assert_array_equal(got["sel_counts"], np.asarray(jst.sel_counts))
        np.testing.assert_allclose(got["logw"], np.asarray(jst.e3cs.logw), rtol=RTOL, atol=ATOL)


def _port_dense(c):
    pm = port_program(c, None)
    run, s0 = pm.build_runner(outputs="full", carry_key=True)
    key = prng.PRNGKey(SEED, "cpu")
    if c["staleness"] is None:
        st, key, masks, second, ps, _ = run(s0, key)
        arrived = None
    else:
        st, key, _, masks, second, ps, _, arrived = run(s0, key, pm.init_rings())
    got = {"masks": masks.numpy(), "second": second.numpy(), "ps": ps.numpy(), "key": key.data.numpy(),
           "sel_counts": st.sel_counts.numpy(), "logw": st.e3cs.logw.numpy()}
    if arrived is not None:
        got["arrived"] = arrived.numpy()
    return got


@pytest.mark.parametrize("c", DENSE, ids=lambda c: c["name"])
def test_dense_horizon_from_a_jax_key(c):
    _check(c, _port_dense(c), *_jax_run(c["name"]))


def test_chunked_jax_key_horizon_equals_one_shot():
    c = _case("e3cs-chunks", staleness=2)
    one = _port_dense(c)
    pm = port_program(c, None)
    run, state = pm.build_runner(outputs="full", carry_key=True, scan_length=T // 2)
    key, rings, masks = prng.PRNGKey(SEED, "cpu"), pm.init_rings(), []
    for _ in range(2):
        state, key, rings, m, *_ = run(state, key, rings)
        masks.append(m.numpy())
    np.testing.assert_array_equal(np.concatenate(masks), one["masks"])
    np.testing.assert_array_equal(key.data.numpy(), one["key"])
    with pytest.raises(ValueError, match="kind of key"):
        run(state, SEED, rings)


@pytest.mark.parametrize("c", [c for c in MESH if c["D"] == 1], ids=lambda c: c["name"])
def test_one_rank_mesh_horizon_from_a_jax_key(c, mesh1):  # noqa: F811
    _check(c, horizon_rank(mesh1, c), *_jax_run(c["name"]))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every two-rank case, one after another on one spawned group."""
    cases = [c for c in MESH if c["D"] == 2]
    ranks = spawn_groups([(horizon_ranks, 2, tmp_path_factory.mktemp("two_ranks"), cases)])[0]
    return {c["name"]: [{n[len(c["name"]) + 1:]: v for n, v in r.items() if n.startswith(c["name"] + "/")}
                        for r in ranks] for c in cases}


@pytest.mark.parametrize("c", [c for c in MESH if c["D"] == 2], ids=lambda c: c["name"])
def test_two_rank_mesh_horizon_from_a_jax_key(c, two_ranks):
    ranks = two_ranks[c["name"]]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["key"], ranks[0]["key"])
    got = {name: np.concatenate([r[name] for r in ranks], axis=-1) for name in ("masks", "second", "ps", "sel_counts",
                                                                                "logw") + (("arrived",) if
                                                                                           c["staleness"] else ())}
    got["key"] = ranks[0]["key"]
    _check(c, got, *_jax_run(c["name"]))

"""The port's K-sharded round against the JAX package's ``RoundProgram(mesh=
...)``, cohort for cohort, on the CPU.

JAX runs each case's whole horizon on a mesh of D of ``conftest.py``'s forced
host devices, with outcomes replayed from a trace (``override="dense"``, ``"packed"`` or
``"packed_lags"``).  The test replays JAX's key discipline to take each round's
per-shard Gumbel rows (``split(key, 3)``, then ``fold_in(k1, d)`` when D > 1,
as ``_ShardCtx`` draws them) and feeds every rank of the port its rows and
its slab of the trace: D = 1 in this process, D = 2 and 4 in spawned gloo
ranks (``test_torch_mesh.run_cases``).  Both the port's fused and staged
rounds are held against JAX's round.

Masks, outcomes, lags and selection counts must be equal exactly.  Floats
are held to ``RTOL``/``ATOL``: the frameworks sum in different orders (tiled
sums, the ranks' partial sums, the block sums), so ``p`` may differ in its
last bits, and those bits reach ``logw`` through ``1/p`` each round.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFLConfig
from repro.core.selection.sampling import local_topk_candidates as jlocal_topk
from repro.core.selection.sampling import merge_topk_candidates as jmerge
from repro.core.volatility import CompletionLag as JCompletionLag
from repro.core.volatility import make_volatility as jmake_volatility
from repro.core.volatility import paper_success_rates as jpaper_success_rates
from repro.engine.round_program import RoundProgram as JRoundProgram
from repro.engine.sharded import masked_prob_alloc as jmasked_prob_alloc
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.scenarios.replay import pack_lags, pack_trace
from repro_torch.core.selection import local_topk_candidates, merge_topk_candidates
from repro_torch.engine.sharded import masked_prob_alloc
from test_torch_mesh import mesh1, run_cases, spawn_groups  # noqa: F401  (mesh1 is a fixture)

k, T, SEED = 16, 20, 3
RTOL, ATOL = 1e-5, 1e-5  # float32 sums in another order: a few ulps in p, carried into logw

CASES = [
    dict(name="d1_sync_b4", D=1, K=256, block=4, staleness=None, feedback="deadline", override="dense"),
    dict(name="d1_async_late_b1", D=1, K=250, block=1, staleness=2, feedback="late_credit", override="dense"),
    dict(name="d2_sync_b1", D=2, K=256, block=1, staleness=None, feedback="deadline", override="dense"),
    dict(name="d2_async_deadline_b4", D=2, K=250, block=4, staleness=2, feedback="deadline", override="dense"),
    dict(name="d2_packed_b4", D=2, K=250, block=4, staleness=None, feedback="deadline", override="packed"),
    dict(name="d2_packed_lags_b4", D=2, K=250, block=4, staleness=2, feedback="late_credit", override="packed_lags"),
    dict(name="d2_resume_async_late_b4", D=2, K=256, block=4, staleness=2, feedback="late_credit",
         override="dense", resume=True),
    dict(name="d4_sync_b4", D=4, K=250, block=4, staleness=None, feedback="deadline", override="dense"),
    dict(name="d4_async_late_b4", D=4, K=256, block=4, staleness=2, feedback="late_credit", override="dense"),
    dict(name="d4_async_deadline_b1", D=4, K=250, block=1, staleness=2, feedback="deadline", override="dense"),
]
for _c in CASES:
    _c.update(k=k, T=T // 2 if _c.get("resume") else T)
BY_NAME = {c["name"]: c for c in CASES}


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_gumbel_rows(key, n, D, Ks):
    """Each round's per-shard selection noise: ``(n, D, Ks)``."""

    def body(key, _):
        key, k1, _ = jax.random.split(key, 3)
        keys = [jax.random.fold_in(k1, d) if D > 1 else k1 for d in range(D)]
        return key, jnp.stack([jax.random.gumbel(kd, (Ks,), jnp.float32) for kd in keys])

    return jax.lax.scan(body, key, None, length=n)[1]


def _trace(c, n):
    rng = np.random.default_rng(11)
    K = c["K"]
    if c["staleness"] is not None:
        lags = rng.choice([0, 1, 2, -1], size=(n, K), p=[0.5, 0.15, 0.1, 0.25]).astype(np.int32)
        return pack_lags(lags) if c["override"] == "packed_lags" else lags
    bits = rng.binomial(1, 0.6, (n, K)).astype(np.float32)
    return pack_trace(bits) if c["override"] == "packed" else bits


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """JAX's run of one case: its outputs, final state, and the inputs the
    port's ranks take (Gumbel rows, trace rows, a starting state)."""
    c = BY_NAME[name]
    K, S, D = c["K"], c["staleness"], c["D"]
    rho = jpaper_success_rates(K)
    vol = jmake_volatility("bernoulli", rho)
    if S is not None:
        vol = JCompletionLag(vol, max_lag=S)
    jpm = JRoundProgram(
        fl=JFLConfig(K=K, k=k, rounds=T, scheme="e3cs", quota_frac=0.5, allocator="bisect"), vol=vol, rho=rho,
        override=c["override"], staleness=S, alpha=0.5, feedback=c["feedback"], mesh=jmake_host_mesh(D),
        block=c["block"],
    )
    Ks = jpm._sharded_geometry()[1]
    xs = _trace(c, T)
    key = jax.random.PRNGKey(SEED)
    inputs = {}
    if c.get("resume"):
        half = T // 2
        run, s0 = jpm.build_runner(outputs="full", carry_key=True, scan_length=half)
        js, key, jrings, *_ = run(s0, key, jpm.init_rings(), jnp.asarray(xs[:half]))
        start = {"logw": js.e3cs.logw, "t": js.t, "sel_counts": js.sel_counts, "loss_cache": js.loss_cache,
                 "vol_state": js.vol_state, "cep": js.cep, "succ_hist": js.succ_hist, "credit": jrings[0],
                 "fb": jrings[1]}
        inputs.update({f"{name}/state/{n}": np.asarray(v) for n, v in start.items()})
        st, _, rings, *outs = run(js, key, jrings, jnp.asarray(xs[half:]))
        xs = xs[half:]
    else:
        run, s0 = jpm.build_runner(outputs="full")
        st, *outs = run(s0, key, jnp.asarray(xs))
        rings = ()
    inputs[f"{name}/xs"] = xs
    inputs[f"{name}/gumbel"] = np.asarray(_jax_gumbel_rows(key, c["T"], D, Ks))
    state = {"logw": st.e3cs.logw, "t": st.t, "sel_counts": st.sel_counts, "loss_cache": st.loss_cache,
             "cep": st.cep}
    state.update(zip(("credit", "fb"), rings))
    fields = ("mask", "x", "p", "sigma") + (("arrived",) if S is not None else ())
    return {f: np.asarray(o) for f, o in zip(fields, outs)}, {n: np.asarray(v) for n, v in state.items()}, inputs


@pytest.fixture(scope="module")
def port_runs(mesh1, tmp_path_factory):  # noqa: F811
    """Every case's port outputs: name -> the ranks' result dicts."""
    tmp = tmp_path_factory.mktemp("sharded")
    inputs = {}
    for c in CASES:
        inputs.update(_jax_case(c["name"])[2])
    npz = tmp / "inputs.npz"
    np.savez(npz, **inputs)
    specs = {D: [c for c in CASES if c["D"] == D] for D in (1, 2, 4)}
    ranks = {1: [run_cases(mesh1, specs[1], str(npz))]}
    ranks.update(zip((2, 4), spawn_groups([(run_cases, D, tmp / f"d{D}", specs[D], str(npz)) for D in (2, 4)])))
    return {c["name"]: ranks[D] for D, cs in specs.items() for c in cs}


@pytest.mark.parametrize("fused", ["fused", "staged"])
@pytest.mark.parametrize("name", list(BY_NAME))
def test_mesh_round_matches_jax(port_runs, name, fused):
    want, want_state, _ = _jax_case(name)
    ranks = port_runs[name]
    got = {f: np.concatenate([r[f"{name}/{fused}/{f}"] for r in ranks], axis=-1) for f in want if f != "sigma"}
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_array_equal(got["x"], want["x"])
    np.testing.assert_allclose(got["p"], want["p"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ranks[0][f"{name}/{fused}/sigma"], want["sigma"], rtol=1e-6)
    if "arrived" in want:
        np.testing.assert_allclose(got["arrived"], want["arrived"], rtol=RTOL, atol=ATOL)
    for r in ranks:  # gathered on every rank
        st = {n[len(f"{name}/{fused}/state/"):]: v for n, v in r.items() if n.startswith(f"{name}/{fused}/state/")}
        np.testing.assert_array_equal(st["sel_counts"], want_state["sel_counts"])
        assert int(st["t"]) == int(want_state["t"])
        for n in ("logw", "loss_cache", "cep") + tuple(f for f in ("credit", "fb") if f in want_state):
            np.testing.assert_allclose(st[n], want_state[n], rtol=RTOL, atol=ATOL, err_msg=n)


@pytest.mark.parametrize("block", [2, 4, 6])
@pytest.mark.parametrize("with_active", [False, True], ids=["dense", "active"])
def test_block_allocator_matches_jax(block, with_active):
    """``p`` within ``RTOL``; ``capped`` equal."""
    rng = np.random.default_rng(block)
    K, kk = 5000, 500
    w = rng.gamma(0.3, 1.0, K).astype(np.float32)
    active = (rng.random(K) < 0.9).astype(np.float32) if with_active else None
    sigma = np.float32(0.25 * kk / K)
    jp, jc = jmasked_prob_alloc(jnp.asarray(w), kk, sigma, active=None if active is None else jnp.asarray(active),
                                block=block)
    p, c = masked_prob_alloc(torch.from_numpy(w), kk, torch.tensor(sigma),
                             active=None if active is None else torch.from_numpy(active), block=block)
    assert bool(np.asarray(jc).any()), "the case must take the capped (bisection) branch"
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=RTOL, atol=0)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


@pytest.mark.parametrize("D", [1, 3, 4])
def test_merge_topk_candidates_with_ties_matches_jax(D):
    """Scores rounded to one decimal tie often, within and across shards;
    the merged indices must equal JAX's, and a dense top-k, exactly."""
    rng = np.random.default_rng(D)
    Ks, kk = 40, 12
    scores = np.round(rng.normal(size=(D, Ks)), 1).astype(np.float32)
    vals, idx = [], []
    for d in range(D):
        jv, ji = jlocal_topk(jnp.asarray(scores[d]), kk, d * Ks)
        v, i = local_topk_candidates(torch.from_numpy(scores[d]), kk, d * Ks)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        vals.append(v)
        idx.append(i)
    got = merge_topk_candidates(torch.cat(vals), torch.cat(idx), kk).numpy()
    want = np.asarray(jmerge(jnp.concatenate([jnp.asarray(v.numpy()) for v in vals]),
                             jnp.concatenate([jnp.asarray(i.numpy()) for i in idx]), kk))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax.lax.top_k(jnp.asarray(scores.reshape(-1)), kk)[1]))

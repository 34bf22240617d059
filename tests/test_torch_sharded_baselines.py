"""The baselines and the scenario models on the port's K-sharded mesh,
against the JAX package's ``RoundProgram(mesh=...)``, and the rest of
``engine.sharded``'s public surface against JAX's.

JAX runs each case's horizon on a mesh of D of ``conftest.py``'s forced host
devices.  The test replays JAX's key discipline (``split(key, 3)`` a round;
``k1`` to the selection, ``k2`` to the model, each folded with the shard
index when D > 1 where JAX folds it) to take each round's noise: a
baseline's K-wide permutation or uniform row, E3CS's per-shard Gumbel rows,
and the model's per-shard uniform rows.  Every rank of the port takes the
same K-wide rows and its own per-shard rows: D = 1 in this process, D = 2
and 4 in spawned gloo ranks (``test_torch_mesh.run_mesh_cases``).

Masks, outcomes, counts and the baselines' ``p`` and UCB state are equal
exactly; E3CS's ``p`` and ``logw`` within ``RTOL``/``ATOL`` (sums in another
order, as in ``test_torch_sharded.py``).  The regional outage is held
against JAX at D = 1 only: JAX draws its region chain from each shard's
folded key, so at D > 1 its shards see different outages, where the port
draws one chain for every rank (ROADMAP §C).  At D = 2 and 4 the port's
ranks hold the same region state, and their bits equal the dense model's
given the same rows.
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
from repro.engine.sharded import distributed_topk as jdistributed_topk
from repro.engine.sharded import plackett_luce_shmap as jplackett_luce_shmap
from repro.engine.sharded import prob_alloc_shmap as jprob_alloc_shmap
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
import repro_torch.scenarios as P
from repro_torch.engine import masked_prob_alloc, plackett_luce_shmap, prob_alloc_sharded
from test_torch_mesh import mesh1, sharded_baselines_rank, spawn_groups, surface_inputs  # noqa: F401

T, SEED = 12, 3
RTOL, ATOL = 1e-5, 1e-5  # E3CS: float32 sums in another order, a few ulps in p carried into logw
BASE = dict(K=250, k=16, T=T, seed=SEED, pow_d=40, staleness=None, scenario=None, override="dense")


def _case(name, D, **kw):
    return dict(BASE, name=name, D=D, **kw)


CASES = (
    [_case(f"{s}_d{D}", D, scheme=s) for s in ("random", "fedcs", "pow_d", "ucb") for D in (1, 2, 4)]
    + [_case("ucb_async_d2", 2, scheme="ucb", staleness=2)]
    + [_case(f"{sc}_d{D}", D, scheme="e3cs", scenario=sc, override="none")
       for sc in ("diurnal", "flash_crowd") for D in (1, 2, 4)]
    + [_case("flash_crowd_async_d2", 2, scheme="e3cs", scenario="flash_crowd", override="none", staleness=2),
       _case("regional_outage_d1", 1, scheme="e3cs", scenario="regional_outage", override="none")]
    + [_case(f"regional_outage_model_d{D}", D, scheme="e3cs", scenario="regional_outage", override="none",
             runner=True) for D in (2, 4)]
)
BY_NAME = {c["name"]: c for c in CASES}


def _trace(c):
    rng = np.random.default_rng(11)
    if c["staleness"] is not None:
        return rng.choice([0, 1, 2, -1], size=(T, c["K"]), p=[0.5, 0.15, 0.1, 0.25]).astype(np.int32)
    return rng.binomial(1, 0.6, (T, c["K"])).astype(np.float32)


def _jax_program(c):
    K = c["K"]
    if c["scenario"] is None:
        rho = jpaper_success_rates(K)
        vol = jmake_volatility("bernoulli", rho)
    else:
        vol, rho = J.make_scenario(c["scenario"], K, T, c["seed"])
    if c["staleness"] is not None:
        vol = JCompletionLag(vol, max_lag=c["staleness"])
    fl = JFLConfig(K=K, k=c["k"], rounds=T, scheme=c["scheme"], quota_frac=0.5, allocator="bisect", pow_d=c["pow_d"])
    return JRoundProgram(fl=fl, vol=vol, rho=rho, override=c["override"], staleness=c["staleness"], alpha=0.5,
                         mesh=jmake_host_mesh(c["D"]))


def _model_rows(c, key, Ks):
    """The uniform rows JAX's model ``sample`` draws from ``key``."""
    sc, S = c["scenario"], c["staleness"]

    def base(key):
        if sc == "diurnal":
            return [jax.random.uniform(key, (Ks,), jnp.float32)]
        if sc == "flash_crowd":
            return [jax.random.uniform(r, (Ks,), jnp.float32) for r in jax.random.split(key)]
        r_reg, r_cli = jax.random.split(key)
        return [jax.random.uniform(r_reg, (8,), jnp.float32), jax.random.uniform(r_cli, (Ks,), jnp.float32)]

    if S is None:
        return base(key)
    r_base, r_late, r_lag = jax.random.split(key, 3)
    return base(r_base) + [jax.random.uniform(r_late, (Ks,), jnp.float32),
                           jax.random.uniform(r_lag, (Ks,), jnp.float32, minval=1e-7, maxval=1.0)]


def _noise(c, Ks):
    """Each round's noise as the JAX mesh runner draws it (module docstring)."""
    D, K, scheme = c["D"], c["K"], c["scheme"]
    key = jax.random.PRNGKey(SEED)
    g, perm, v, u = [], [], [], []
    for _ in range(T):
        key, k1, k2 = jax.random.split(key, 3)
        fold = (lambda kk, d: jax.random.fold_in(kk, d)) if D > 1 else (lambda kk, d: kk)
        if scheme == "e3cs":
            g.append(np.stack([np.asarray(jax.random.gumbel(fold(k1, d), (Ks,), jnp.float32)) for d in range(D)]))
        elif scheme in ("random", "pow_d"):
            perm.append(np.asarray(jax.random.permutation(k1, K)))
        elif scheme == "fedcs":
            v.append(np.asarray(jax.random.uniform(k1, (K,), jnp.float32)))
        if c["override"] == "none":
            u.append([np.stack(r) for r in zip(*(map(np.asarray, _model_rows(c, fold(k2, d), Ks))
                                                for d in range(D)))])
    out = {"g": g, "perm": perm, "v": v}
    out = {f"{c['name']}/{n}": np.stack(a) for n, a in out.items() if a}
    for i, rows in enumerate(zip(*u)):
        out[f"{c['name']}/u{i}"] = np.stack(rows)
    return out


def _model_check_noise(c, Ks):
    """For the port-only regional-outage cases: one region row a round for
    every rank, and each rank's slab of one client row."""
    D = c["D"]
    rng = np.random.default_rng(D)
    reg = rng.random((T, 8), dtype=np.float32)
    cli = rng.random((T, D * Ks), dtype=np.float32)
    g = rng.gumbel(size=(T, D, Ks)).astype(np.float32)
    name = c["name"]
    return {f"{name}/g": g, f"{name}/u0": np.repeat(reg[:, None], D, axis=1),
            f"{name}/u1": cli.reshape(T, D, Ks), f"{name}/full_cli": cli, f"{name}/full_reg": reg}


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """JAX's run of one case (None for the port-only cases) and the inputs
    the port's ranks take."""
    c = BY_NAME[name]
    jpm = _jax_program(c)
    Ks = jpm._sharded_geometry()[1]
    if name.startswith("regional_outage_model"):
        return None, _model_check_noise(c, Ks)
    xs = _trace(c)
    inputs = _noise(c, Ks)
    if c["override"] == "dense":
        inputs[f"{name}/xs"] = xs
    run, s0 = jpm.build_runner(outputs="full")
    st, *outs = run(s0, jax.random.PRNGKey(SEED), jnp.asarray(xs) if c["override"] == "dense" else jnp.zeros((T, 0)))
    fields = ("mask", "x", "p", "sigma") + (("arrived",) if c["staleness"] is not None else ())
    want = {f: np.asarray(o) for f, o in zip(fields, outs)}
    want["state"] = {"sel_counts": np.asarray(st.sel_counts), "loss_cache": np.asarray(st.loss_cache),
                     "logw": np.asarray(st.e3cs.logw), "t": np.asarray(st.t),
                     "ucb_succ": np.asarray(st.ucb.succ), "ucb_pulls": np.asarray(st.ucb.pulls),
                     "vol_state": [np.asarray(v) for v in jax.tree.leaves(st.vol_state)]}
    return want, inputs


@pytest.fixture(scope="module")
def port_runs(mesh1, tmp_path_factory):  # noqa: F811
    """Every case's port outputs: name -> the ranks' result dicts."""
    tmp = tmp_path_factory.mktemp("sharded_baselines")
    inputs = {}
    for c in CASES:
        inputs.update(_jax_case(c["name"])[1])
    npz = tmp / "inputs.npz"
    np.savez(npz, **inputs)
    specs = {D: [c for c in CASES if c["D"] == D] for D in (1, 2, 4)}
    ranks = {1: [sharded_baselines_rank(mesh1, specs[1], str(npz))]}
    ranks.update(zip((2, 4), spawn_groups([(sharded_baselines_rank, D, tmp / f"d{D}", specs[D], str(npz))
                                           for D in (2, 4)])))
    return {**{c["name"]: ranks[D] for D, cs in specs.items() for c in cs}, **{f"D{D}": ranks[D] for D in ranks}}


def _gathered(ranks, tag, field):
    return np.concatenate([r[f"{tag}/{field}"] for r in ranks], axis=-1)


JAX_CASES = [c["name"] for c in CASES if not c["name"].startswith("regional_outage_model")]


@pytest.mark.parametrize("name", JAX_CASES)
def test_mesh_scheme_and_model_match_jax(port_runs, name):
    want, _ = _jax_case(name)
    c, ranks = BY_NAME[name], port_runs[name]
    e3cs = c["scheme"] == "e3cs"
    for variant in ("fused", "staged") if e3cs else ("staged",):
        tag = f"{name}/{variant}"
        np.testing.assert_array_equal(_gathered(ranks, tag, "mask"), want["mask"], err_msg=tag)
        np.testing.assert_array_equal(_gathered(ranks, tag, "x"), want["x"], err_msg=tag)
        p = _gathered(ranks, tag, "p")
        if e3cs:
            np.testing.assert_allclose(p, want["p"], rtol=RTOL, atol=ATOL, err_msg=tag)
        else:
            np.testing.assert_array_equal(p, want["p"], err_msg=tag)
        if "arrived" in want:
            np.testing.assert_allclose(_gathered(ranks, tag, "arrived"), want["arrived"], rtol=RTOL, atol=ATOL)
        for r in ranks:  # the state, gathered on every rank
            st = want["state"]
            np.testing.assert_array_equal(r[f"{tag}/state/sel_counts"], st["sel_counts"])
            np.testing.assert_array_equal(r[f"{tag}/state/loss_cache"], st["loss_cache"])
            np.testing.assert_array_equal(r[f"{tag}/state/ucb_succ"], st["ucb_succ"][: c["K"]])
            np.testing.assert_array_equal(r[f"{tag}/state/ucb_pulls"], st["ucb_pulls"][: c["K"]])
            assert int(r[f"{tag}/state/t"]) == int(st["t"])
            np.testing.assert_allclose(r[f"{tag}/state/logw"], st["logw"], rtol=RTOL, atol=ATOL)
            vs = [r[f"{tag}/state/vol_state{i}"] for i in range(len(st["vol_state"]))] if len(
                st["vol_state"]) > 1 else [r[f"{tag}/state/vol_state"]]
            for a, b in zip(vs, st["vol_state"]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("D", [2, 4])
def test_regional_outage_chain_is_one_on_every_rank(port_runs, D):
    """The port's region chain at D > 1: every rank holds the same region
    row (from the shared stream in the runner, from the same row in the
    step), and the ranks' bits and state equal the dense model's given the
    same rows."""
    name = f"regional_outage_model_d{D}"
    ranks, (_, inputs) = port_runs[name], _jax_case(name)
    runner_states = [r[f"{name}/runner/vol_state"] for r in ranks]
    assert all(np.array_equal(s, runner_states[0]) for s in runner_states)
    vol, _ = P.make_scenario("regional_outage", BASE["K"], T, SEED, device="cpu")
    state, xs = vol.init_state(), []
    for t in range(T):
        rows = (torch.from_numpy(inputs[f"{name}/full_reg"][t]),
                torch.from_numpy(inputs[f"{name}/full_cli"][t][: BASE["K"]]))
        x, state = vol.sample(rows, state)
        xs.append(x.numpy())
    for variant in ("fused", "staged"):
        np.testing.assert_array_equal(_gathered(ranks, f"{name}/{variant}", "x")[:, : BASE["K"]], np.stack(xs))
        for r in ranks:
            np.testing.assert_array_equal(r[f"{name}/{variant}/state/vol_state"], state.numpy())


@pytest.mark.parametrize("D", [1, 2, 4])
def test_public_sharded_surface_matches_jax(port_runs, mesh1, D):  # noqa: F811
    """``prob_alloc_shmap``, ``distributed_topk`` and ``plackett_luce_shmap``
    on every rank (``test_torch_mesh.surface_on_rank``, k = 40) against
    JAX's on a D-device mesh; ``prob_alloc_sharded`` is ``masked_prob_alloc``
    over every client."""
    K, kk = 1001, 40
    w, scores, p, g_rows = surface_inputs(D)
    jmesh = jmake_host_mesh(D)
    jp, jc = jprob_alloc_shmap(jnp.asarray(w), kk, 0.01, jmesh)
    want_pl = np.asarray(jax.lax.top_k(np.log(np.maximum(p, 1e-20)) + g_rows.reshape(-1)[:K], kk)[1])
    for r in port_runs[f"D{D}"]:
        np.testing.assert_allclose(r["surface/p"], np.asarray(jp), rtol=1e-6, atol=0)
        np.testing.assert_array_equal(r["surface/capped"], np.asarray(jc))
        np.testing.assert_array_equal(r["surface/topk"], np.asarray(jdistributed_topk(jnp.asarray(scores), kk, jmesh)))
        np.testing.assert_array_equal(r["surface/pl"], want_pl)
    if D == 1:
        # JAX's own draw at D = 1 (no fold_in), handed over as the rank's slab
        g = torch.from_numpy(np.array(jax.random.gumbel(jax.random.PRNGKey(0), (K,), jnp.float32)))
        np.testing.assert_array_equal(
            plackett_luce_shmap(g, torch.from_numpy(p), kk, mesh1).numpy(),
            np.asarray(jplackett_luce_shmap(jax.random.PRNGKey(0), jnp.asarray(p), kk, jmesh)))
        pd, cd = prob_alloc_sharded(torch.from_numpy(w), kk, 0.01)
        pm, cm = masked_prob_alloc(torch.from_numpy(w), kk, 0.01)
        assert torch.equal(pd, pm) and torch.equal(cd, cm)


ONE_RANK = [("random", "bernoulli", False, 0), ("fedcs", "bernoulli", False, 0), ("pow_d", "markov", False, 0),
            ("ucb", "bernoulli", False, 2), ("e3cs", "diurnal", True, 0), ("e3cs", "regional_outage", True, 0),
            ("e3cs", "flash_crowd", False, 2), ("random", "regional_outage", False, 0)]


@pytest.mark.parametrize("scheme,volatility,fused,S", ONE_RANK, ids=[f"{s}-{v}-S{S}" for s, v, _, S in ONE_RANK])
def test_one_rank_mesh_equals_the_dense_runner(mesh1, scheme, volatility, fused, S):  # noqa: F811
    """At D = 1 the mesh's own and shared streams are one generator drawn in
    the dense order, so a one-rank ``block=1`` mesh runner equals the dense
    ``allocator="bisect"`` runner bit for bit, for every scheme and model
    (JAX's contract, ``repro.engine.sharded.build_sharded_scan_runner``)."""
    from repro_torch.configs import FLConfig
    from repro_torch.engine import RoundProgram

    fl = FLConfig(K=250, k=8, rounds=T, scheme=scheme, quota_frac=0.5, allocator="bisect", volatility=volatility,
                  seed=1, pow_d=16, staleness_rounds=S)
    runs = []
    for m in (None, mesh1):
        run, s0 = RoundProgram.from_config(fl, mesh=m, fused=fused, device="cpu").build_runner()
        runs.append(run(s0, 5))
    a, b = (torch.utils._pytree.tree_leaves(r) for r in runs)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.all(runs[0][1].sum(1) == 8)

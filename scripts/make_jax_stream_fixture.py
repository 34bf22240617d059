"""Write the JAX key stream's fixtures for the card, where there is no JAX:
``tests/golden_torch/``.

Run from the repository root with the JAX package importable::

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_jax_stream_fixture.py [stream] [drivers]

(both parts when none is named; ``drivers`` alone takes about three minutes
on four CPU threads).  ``stream`` writes:

* ``jax_stream.npz``: the JAX package's E3CS horizon at K = 10^6, k = 1000
  (``HORIZON``: Bernoulli volatility at the paper's success rates, sync and
  with completion lags at S = 2, the staged bisection allocator) from
  ``PRNGKey(0)`` for ``T`` rounds: each round's cohort (ascending ids), the
  k-th and (k+1)-th perturbed scores ``log p + g``, the first 4096 Gumbel
  values of round 0 and the key after the horizon;
* ``stems/<slots|sharded>_S<0|2>/``: a JAX server checkpoint of each engine
  after ``TICKS_BEFORE`` ticks of two jobs (``JOBS``; the feedback rows are
  ``feedback(j, t, K, S)``, an integer hash, so the card makes the same rows
  without a random generator), written with the zlib codec (the card has no
  ``zstandard``), and ``served.json``, what the uninterrupted JAX server
  served in the ``TICKS_AFTER`` ticks after.

``chip_smoke.py``'s ``[jax-stream]`` phase holds the port against these.

``drivers`` writes ``jax_drivers.npz``, what the JAX package's int-seed
drivers give at full size, for ``chip_smoke.py``'s ``[jax-stream-drivers]``
phase (``jax_stream_drivers_path``, one check each):

* ``fl/*``: ``FLServer`` at the paper's Table I (EMNIST, K = 100, k = 20,
  E3CS, ``FLConfig``'s defaults) from ``init_state(PRNGKey(0))`` for
  ``FL_ROUNDS`` rounds: ``fl/cohorts`` (rounds, k) every round's cohort,
  ``fl/success`` (rounds, k) its success bits, ``fl/cep``; ``fl/init/<leaf>``
  and ``fl/round1/<leaf>`` each leaf's values at ``positions(leaf size)``,
  initial and after round 1 (the port's layout: conv kernels OIHW);
* ``fleet/S<0|2>/*``: the fleet job ``run_service_sharded(K = 10^6,
  rounds = FLEET_ROUNDS, D = 1, block = 4)``: ``tap_counters`` (a JSON
  string) and, from the same program's runner with every output
  (``PRNGKey(0)``, the same keys), ``cohorts`` (rounds, k) and ``bounds``
  (rounds, 2) the k-th and (k+1)-th perturbed scores;
* ``compiled/S<0|2>``: ``run_service_compiled(J = 8, K_max = 100,000,
  COMPILED_TICKS ticks)``'s ``[on_time_total, stale_credit_total]``;
* ``replay/*``: the replay cell ``run_replay("e3cs", "markov", K = 10^6,
  k = 1000, T = REPLAY_T)``: ``sha256`` of the packed trace (hex), then
  ``scan_selection_sim`` on that trace as ``run_replay`` calls it:
  ``cohorts`` and ``bounds``;
* ``gemma/*``: gemma-2b's ``model.init(PRNGKey(0))`` at its full config,
  in bfloat16, at ``positions`` of two leaves: ``tok_emb`` (the
  ``normal(fold_in(rng, 1))`` embedding at 0.02) and ``seg0/attn/wq`` of
  layer ``GEMMA_LAYER`` (drawn by the JAX package's own ``_block_init`` for
  that one layer), as the int16 bits of the bfloat16 values;
* ``config``: the sizes above, as JSON.
"""
import json
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "golden_torch")
HORIZON = dict(K=1_000_000, k=1000, T=5, seed=0, quota_frac=0.5, alpha=0.5, staleness=(None, 2))
JOBS = (dict(K=1_000_000, k=1000, seed=3, rounds=400), dict(K=500_000, k=500, seed=11, rounds=400, sigma_frac=0.3))
TICKS_BEFORE, TICKS_AFTER = 3, 5
GUMBEL_HEAD = 4096
FL_ROUNDS, FLEET_ROUNDS, COMPILED_TICKS, REPLAY_T, GEMMA_LAYER = 5, 5, 5, 5, 7
SAMPLE = 4096  # positions held a leaf


def positions(n: int) -> np.ndarray:
    """The flat positions of a leaf of ``n`` elements a check reads:
    ``SAMPLE`` of them spread by a multiplicative hash (all when fewer)."""
    if n <= SAMPLE:
        return np.arange(n, dtype=np.int64)
    return (np.arange(SAMPLE, dtype=np.int64) * 2654435761 + 12345) % n


def feedback(j, t, K, S):
    """Job ``j``'s round-``t`` lag codes (``S = 0``: 0 on time, -1 dead), an
    integer hash of (j, t, client): about 70 % on time; under S > 0 about 15 %
    one round late, 10 % S rounds late."""
    h = (np.arange(K, dtype=np.uint64) * np.uint64(2654435761) + np.uint64(40503 * t + 9973 * j + 1)) % np.uint64(1000)
    h = h.astype(np.int64)
    if not S:
        return np.where(h < 700, 0, -1).astype(np.int32)
    return np.where(h < 550, 0, np.where(h < 700, 1, np.where(h < 800, S, -1))).astype(np.int32)


def horizon(staleness):
    import jax
    import jax.numpy as jnp

    from repro.configs import FLConfig
    from repro.core.volatility import CompletionLag, make_volatility, paper_success_rates
    from repro.engine.round_program import RoundProgram

    H = HORIZON
    K, k, T = H["K"], H["k"], H["T"]
    rho = paper_success_rates(K)
    vol = make_volatility("bernoulli", rho)
    if staleness is not None:
        vol = CompletionLag(vol, max_lag=staleness)
    fl = FLConfig(K=K, k=k, rounds=T, scheme="e3cs", quota_frac=H["quota_frac"], allocator="bisect")
    pm = RoundProgram(fl=fl, vol=vol, rho=rho, staleness=staleness, alpha=H["alpha"])
    run, s0 = pm.build_runner(outputs="full", carry_key=True)
    key0 = jax.random.PRNGKey(H["seed"])
    xs = jnp.zeros((T, 0), jnp.float32)
    if staleness is None:
        _, key, masks, _, ps, _ = run(s0, key0, xs)
    else:
        _, key, _, masks, _, ps, _, _ = run(s0, key0, pm.init_rings(), xs)
    masks, ps = np.asarray(masks), np.asarray(ps)
    cohorts, bounds, head = [], [], None
    kk = key0
    for t in range(T):
        kk, k1, _ = jax.random.split(kk, 3)
        g = np.asarray(jax.random.gumbel(k1, (K,), jnp.float32))
        if t == 0:
            head = g[:GUMBEL_HEAD]
        s = np.log(np.maximum(ps[t], 1e-30)) + g
        top = np.sort(s)[::-1][: k + 1]
        cohorts.append(np.nonzero(masks[t] > 0)[0].astype(np.int32))
        bounds.append(top[k - 1: k + 1])
    return np.stack(cohorts), np.stack(bounds), head, np.asarray(key)


def stems():
    import repro.checkpoint.checkpoint as ckpt
    from repro.serve import JobSpec, ShardedEngine, SlotEngine, save_server

    ckpt._CODEC = "zlib"
    for kind in ("slots", "sharded"):
        for S in (0, 2):
            eng = SlotEngine(K_max=JOBS[0]["K"], k_cap=JOBS[0]["k"], staleness=S, buckets=(4,)) if kind == "slots" \
                else ShardedEngine(D=1, staleness=S)
            uids = [eng.admit(JobSpec(**j)) for j in JOBS]

            def tick(t):
                return eng.tick([(u, feedback(j, t, JOBS[j]["K"], S)) for j, u in enumerate(uids)])

            for t in range(TICKS_BEFORE):
                tick(t)
            d = os.path.join(OUT, "stems", f"{kind}_S{S}")
            shutil.rmtree(d, ignore_errors=True)
            save_server(d, eng, step=TICKS_BEFORE)
            served = []
            for t in range(TICKS_BEFORE, TICKS_BEFORE + TICKS_AFTER):
                out = tick(t)
                served.append({str(u): {"round": r["round"], "cohort": [int(c) for c in r["cohort"]],
                                        "on_time": r["on_time"]} for u, r in out.items()})
            with open(os.path.join(d, "served.json"), "w") as f:
                json.dump({"jobs": JOBS, "uids": uids, "ticks_before": TICKS_BEFORE, "served": served}, f)
            print(kind, S, {n: os.path.getsize(os.path.join(d, n)) for n in sorted(os.listdir(d))}, flush=True)


def _full_horizon(pm, T, seed):
    """Cohorts and k-th / (k+1)-th perturbed scores of ``pm``'s full-output
    runner from ``PRNGKey(seed)`` (its round ``t`` Gumbel row is
    ``gumbel(split(key_t, 3)[1], (K,))``)."""
    import jax
    import jax.numpy as jnp

    K, k = pm.fl.K, pm.fl.k
    run, s0 = pm.build_runner(outputs="full")
    key0 = jax.random.PRNGKey(seed)
    xs = jnp.zeros((T, 0), jnp.float32)
    _, masks, _, ps, *_ = run(s0, key0, xs)
    masks, ps = np.asarray(masks)[:, :K], np.asarray(ps)[:, :K]
    cohorts, bounds, kk = [], [], key0
    for t in range(T):
        kk, k1, _ = jax.random.split(kk, 3)
        s = np.log(np.maximum(ps[t], 1e-30)) + np.asarray(jax.random.gumbel(k1, (K,), jnp.float32))
        cohorts.append(np.nonzero(masks[t] > 0)[0].astype(np.int32))
        bounds.append(np.sort(s)[::-1][k - 1: k + 1])
    return np.stack(cohorts), np.stack(bounds)


def _fl_leaves(params):
    """A CNN's leaves in the port's layout (conv kernels HWIO -> OIHW)."""
    return {n: (np.asarray(v).transpose(3, 2, 0, 1) if np.ndim(v) == 4 else np.asarray(v)) for n, v in params.items()}


def drivers():
    import hashlib

    import jax
    import jax.numpy as jnp

    from repro.configs import FLConfig, get_config
    from repro.engine.round_program import RoundProgram
    from repro.engine.scan_sim import scan_selection_sim
    from repro.fl import FLServer
    from repro.launch.mesh import make_host_mesh
    from repro.launch.select_serve import run_service_compiled, run_service_sharded
    from repro.launch.train import build_task
    from repro.models import transformer
    from repro.scenarios import make_scenario, record_trace

    out = {}
    # -- FL at Table I ---------------------------------------------------------------
    fl = FLConfig(rounds=FL_ROUNDS)
    model, store, _ = build_task("emnist", fl)
    srv = FLServer(model, fl, store)
    cohorts, success, params = [], [], []
    select, round_fn = srv._select, srv._round

    def recording_round(state, idx, *args):
        rng = args[-1]
        r_vol = jax.random.split(jax.random.fold_in(rng, 1))[0]
        x_full, _ = srv.vol.sample(r_vol, state.vol_state)
        cohorts.append(np.asarray(idx))
        success.append(np.asarray(x_full)[np.asarray(idx)] > 0)
        res = round_fn(state, idx, *args)
        params.append(res[0].params)
        return res

    srv._round = recording_round
    st0 = srv.init_state(jax.random.PRNGKey(0))
    st, _ = srv.run(st0)
    out["fl/cohorts"], out["fl/success"] = np.stack(cohorts).astype(np.int32), np.stack(success)
    out["fl/cep"] = np.asarray(float(st.cep))
    for tag, tree in (("init", st0.params), ("round1", params[0])):
        for n, v in _fl_leaves(tree).items():
            out[f"fl/{tag}/{n}"] = v.reshape(-1)[positions(v.size)].astype(np.float32)
    print("fl", "cohorts", out["fl/cohorts"].shape, "cep", float(st.cep), flush=True)

    # -- the fleet job, K = 10^6 ----------------------------------------------------
    K, k = 1_000_000, 1000
    for S in (0, 2):
        rep = run_service_sharded(K=K, rounds=FLEET_ROUNDS, D=1, k=k, block=4, reps=1, staleness=S)
        fl = FLConfig(K=K, k=k, rounds=FLEET_ROUNDS, scheme="e3cs", quota_frac=0.5, allocator="bisect",
                      volatility="bernoulli", staleness_rounds=S, staleness_alpha=0.5)
        pm = RoundProgram.from_config(fl, mesh=make_host_mesh(1), block=4)
        c, b = _full_horizon(pm, FLEET_ROUNDS, 0)
        out[f"fleet/S{S}/cohorts"], out[f"fleet/S{S}/bounds"] = c, b
        out[f"fleet/S{S}/tap_counters"] = np.array(json.dumps({n: float(v) for n, v in rep["tap_counters"].items()}))
        print("fleet", S, rep["tap_counters"], "gap min", float((b[:, 0] - b[:, 1]).min()), flush=True)

    # -- run_service_compiled, J = 8, K_max = 100,000 -------------------------------
    for S in (0, 2):
        rep = run_service_compiled(J=8, K_max=100_000, rounds=COMPILED_TICKS, seed=0, staleness=S, reps=1)
        out[f"compiled/S{S}"] = np.array([rep["on_time_total"], rep["stale_credit_total"]], np.float64)
        print("compiled", S, out[f"compiled/S{S}"], flush=True)

    # -- the replay cell --------------------------------------------------------------
    vol, rho = make_scenario("markov", K, REPLAY_T, 0)
    packed = np.asarray(record_trace(vol, REPLAY_T, seed=0, chunk=REPLAY_T))
    out["replay/sha256"] = np.array(hashlib.sha256(packed.tobytes()).hexdigest())
    res = scan_selection_sim("e3cs", K=K, k=k, T=REPLAY_T, frac=0.5, seed=0, rho=rho, packed_override=packed)
    masks, ps = np.asarray(res["masks"]), np.asarray(res["ps"])
    cohorts, bounds, kk = [], [], jax.random.PRNGKey(0)
    for t in range(REPLAY_T):
        kk, k1, _ = jax.random.split(kk, 3)
        s = np.log(np.maximum(ps[t], 1e-30)) + np.asarray(jax.random.gumbel(k1, (K,), jnp.float32))
        cohorts.append(np.nonzero(masks[t] > 0)[0].astype(np.int32))
        bounds.append(np.sort(s)[::-1][k - 1: k + 1])
    out["replay/cohorts"], out["replay/bounds"] = np.stack(cohorts), np.stack(bounds)
    print("replay", out["replay/sha256"], flush=True)

    # -- gemma-2b's initial parameters at sampled positions ------------------------
    cfg = get_config("gemma-2b")
    rng = jax.random.PRNGKey(0)
    V, d = cfg.vocab, cfg.d_model
    pos = positions(V * d)
    # the embedding is the model's first draw: normal(fold_in(rng, 1), (V, d)) at 0.02, in bfloat16; a value
    # depends only on its key and flat position, so it is drawn at the positions alone (checked on a small draw)
    key = jax.random.fold_in(rng, 1)

    def normal_at(key, flat):
        from jax._src import prng as jprng

        kd = jax.random.key_data(key)
        flat = jnp.asarray(flat, jnp.uint32)
        a, b = jprng.threefry2x32_p.bind(kd[0], kd[1], jnp.zeros_like(flat), flat)
        bits = a ^ b
        f = jax.lax.bitcast_convert_type((bits >> 9) | jnp.uint32(0x3F800000), jnp.float32) - 1.0
        lo = np.nextafter(np.float32(-1), np.float32(0))
        u = jnp.maximum(lo, f * (np.float32(1) - lo) + lo)
        return np.float32(np.sqrt(2)) * jax.lax.erf_inv(u)

    small = np.arange(5000)
    assert np.array_equal(np.asarray(jax.jit(normal_at)(key, small)), np.asarray(jax.random.normal(key, (5000,))))
    emb = (jax.jit(normal_at)(key, pos).astype(jnp.bfloat16) * 0.02).astype(jnp.bfloat16)
    out["gemma/tok_emb"] = np.asarray(emb).view(np.int16)
    # one layer of the first segment, by the JAX package's own block init
    kind, n = transformer.segments_of(cfg)[0]
    layer_key = jax.random.split(jax.random.fold_in(rng, 1000), n)[GEMMA_LAYER]
    block, _ = transformer._block_init(layer_key, cfg, kind)
    wq = np.asarray(block["attn"]["wq"])
    out["gemma/wq"] = wq.reshape(-1)[positions(wq.size)].view(np.int16)
    out["gemma/wq_shape"] = np.array(wq.shape)
    print("gemma", "wq", wq.shape, flush=True)

    out["config"] = np.array(json.dumps(dict(fl_rounds=FL_ROUNDS, fleet=dict(K=K, k=k, rounds=FLEET_ROUNDS, block=4),
                                             compiled=dict(J=8, K_max=100_000, rounds=COMPILED_TICKS),
                                             replay=dict(scenario="markov", K=K, k=k, T=REPLAY_T, frac=0.5),
                                             gemma=dict(layer=GEMMA_LAYER), sample=SAMPLE, seed=0)))
    np.savez_compressed(os.path.join(OUT, "jax_drivers.npz"), **out)
    print("jax_drivers.npz", os.path.getsize(os.path.join(OUT, "jax_drivers.npz")), "bytes", flush=True)


def main():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    os.makedirs(OUT, exist_ok=True)
    parts = sys.argv[1:] or ["stream", "drivers"]
    if "drivers" in parts:
        drivers()
    if "stream" not in parts:
        return
    out = {"config": np.array(json.dumps({**HORIZON, "gumbel_head": GUMBEL_HEAD}))}
    for S in HORIZON["staleness"]:
        tag = "sync" if S is None else f"S{S}"
        cohorts, bounds, head, key = horizon(S)
        out.update({f"{tag}/cohorts": cohorts, f"{tag}/bounds": bounds, f"{tag}/key": key})
        out["gumbel_head"] = head
        print(tag, "cohorts", cohorts.shape, "k-th minus (k+1)-th:", (bounds[:, 0] - bounds[:, 1]).tolist(), flush=True)
    np.savez_compressed(os.path.join(OUT, "jax_stream.npz"), **out)
    stems()


if __name__ == "__main__":
    main()

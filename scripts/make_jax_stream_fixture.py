"""Write the JAX key stream's fixtures for the card, where there is no JAX:
``tests/golden_torch/``.

Run from the repository root with the JAX package importable::

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_jax_stream_fixture.py

It writes:

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


def main():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    os.makedirs(OUT, exist_ok=True)
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

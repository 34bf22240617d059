"""Serving demo on the PyTorch/CUDA port: the selection engine behind a
real socket, end to end (``examples/serve_demo.py``'s run).

Stands up a ``SelectionServer`` (``repro_torch.serve``) on the loopback,
then acts as two tenant FL coordinators: admit two jobs of different
shapes, drive volatile rounds through the streaming batcher, checkpoint,
**kill the server**, restore a new one from disk mid-horizon, and finish,
printing how many distinct clients each job saw.  Every byte crosses a TCP
socket in the JAX package's wire protocol (``docs/serving.md``).

    PYTHONPATH=src python examples/torch_serve_demo.py               # on the card
    PYTHONPATH=src python examples/torch_serve_demo.py --rounds 40 --staleness 2 --device cpu
"""
import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.serve import SelectionServer, ServeClient, SlotEngine, latest_server_checkpoint, load_server


def volatile_round(rng, K, S):
    """Completion lags for one round: 0 = on time, 1..S = late, -1 = never."""
    lag = rng.integers(0, S + 2, K).astype(np.int32)
    return np.where(lag > S, -1, lag)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--staleness", type=int, default=2, help="late-credit ring depth S")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    S, half, dev = args.staleness, args.rounds // 2, args.device
    rng = np.random.default_rng(0)
    ckpt_dir = tempfile.mkdtemp(prefix="serve_demo_")
    try:
        print(f"=== first life: 2 tenants, {half} rounds each ===")
        srv = SelectionServer(SlotEngine(K_max=512, k_cap=32, staleness=S, buckets=(4, 8), device=dev),
                              ckpt_dir=ckpt_dir, ckpt_every=20)
        srv.start()
        host, port = srv.address
        print(f"server on {host}:{port}, checkpoints -> {ckpt_dir}")
        c = ServeClient(host, port)
        jobs = [c.admit(K=384, k=24, seed=1), c.admit(K=128, k=8, seed=2)]
        Ks = {jobs[0]: 384, jobs[1]: 128}
        cohorts = {j: [] for j in jobs}
        for _ in range(half):
            for j in jobs:
                cohorts[j].append(c.tick(j, lags=volatile_round(rng, Ks[j], S))["cohort"])
        print(f"round {half - 1} cohort sizes:", {j: len(cohorts[j][-1]) for j in jobs})
        print("forced checkpoint:", c.checkpoint())
        c.close()
        srv.kill()  # crash, not drain: whatever wasn't checkpointed is gone
        print("server killed (no drain)")

        print("=== second life: restore and finish the horizon ===")
        stem = latest_server_checkpoint(ckpt_dir)
        engine, step = load_server(stem, device=dev)
        print(f"restored {stem} at {step} served rounds, jobs {sorted(engine.jobs)}")
        with SelectionServer(engine, ckpt_dir=ckpt_dir) as srv2:
            c = ServeClient.connect(srv2.address)
            for _ in range(half, args.rounds):
                for j in jobs:
                    cohorts[j].append(c.tick(j, lags=volatile_round(rng, Ks[j], S))["cohort"])
            stats = c.stats()
            c.close()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"finished: {args.rounds} rounds/job, second-life stats {stats['stats']}")
    distinct = {}
    for j in jobs:
        distinct[j] = len({i for coh in cohorts[j] for i in coh})
        print(f"job {j}: K={Ks[j]}, {distinct[j]} distinct clients selected across the horizon")
    print("(restart is bit-identical: tests/test_torch_serve_acceptance.py pins cohort equality "
          "against an uninterrupted run)")
    return {"cohorts": cohorts, "restored_step": step, "distinct": distinct, "stats": stats["stats"]}


if __name__ == "__main__":
    main()

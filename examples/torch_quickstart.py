"""Quickstart on the PyTorch/CUDA port: the E3CS selection engine over a
whole horizon, one CUDA-graph replay a round (``examples/quickstart.py``'s
run on the port).

Builds the paper's protocol straight from an ``FLConfig`` through
``RoundProgram.from_config`` and runs the horizon with the round's taps on:
10,000 volatile clients (Bernoulli success classes 0.1/0.3/0.6/0.9), E3CS
exponential-weight selection with the incremental fairness schedule,
deadline-based feedback.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

``staleness_rounds=S`` makes the horizon asynchronous, ``mesh=
make_host_mesh(D)`` shards the client axis over D ranks, and
``repro_torch.serve`` puts a socket in front of it (see
``examples/torch_serve_demo.py``).
"""
import argparse

from repro_torch.configs import FLConfig
from repro_torch.engine import RoundProgram


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--K", type=int, default=10_000)
    ap.add_argument("--k", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    fl = FLConfig(K=args.K, k=args.k, rounds=args.rounds, scheme="e3cs", quota="inc", seed=0)
    program = RoundProgram.from_config(fl, device=args.device)  # volatility: the paper's Bernoulli classes
    # the whole horizon: feedback is drawn in the round, noise from the seed
    run, state0 = program.build_runner(outputs="lean", taps=True)
    state, successes, sigmas, taps = run(state0, fl.seed)

    cep = float(successes.sum())  # cumulative effective participation (paper Eq. 8)
    print(f"rounds={fl.rounds}  K={fl.K}  cohort k={fl.k}  device={program.device}")
    print(f"CEP: {cep:.0f} / {fl.rounds * fl.k} issued slots ({cep / (fl.rounds * fl.k):.1%} effective)")
    print(f"fairness quota sigma: {float(sigmas[0]):.4f} -> {float(sigmas[-1]):.4f} (inc schedule)")
    counts = state.sel_counts.cpu().numpy().reshape(4, -1).sum(1).astype(int).tolist()
    print("selections by volatility class (rho=0.1/0.3/0.6/0.9):", counts)
    per_round = {name: float(series.float().mean()) for name, series in taps["series"].items()}
    print("per-round telemetry (means):", {name: round(v, 2) for name, v in sorted(per_round.items())})
    return {"cep": cep, "class_counts": counts, "sigmas": (float(sigmas[0]), float(sigmas[-1])), "taps": per_round}


if __name__ == "__main__":
    main()

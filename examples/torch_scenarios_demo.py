"""Scenario subsystem tour on the PyTorch/CUDA port
(``examples/scenarios_demo.py``'s three stops):

1. three selectors against four availability regimes (iid paper classes,
   sticky Markov, diurnal cycles, correlated regional outages), each cell
   one whole-horizon runner;
2. the scenario axis on the batched multi-job engine: one E3CS row a
   scenario, one batched step a round;
3. the regional-outage scenario recorded as a bit-packed trace (8 clients a
   byte) and replayed: selections bit-identical to the dense replay at 1/32
   of the trace's memory.

    PYTHONPATH=src python examples/torch_scenarios_demo.py               # on the card
    PYTHONPATH=src python examples/torch_scenarios_demo.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.engine.scan_sim import scan_selection_sim
from repro_torch.scenarios import format_grid, make_scenario, record_trace, run_grid, run_grid_multi_job, unpack_trace

SCENARIOS = ("paper_iid", "markov_sticky", "diurnal", "regional_outage")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--K", type=int, default=100)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--T", type=int, default=400)
    ap.add_argument("--T-multi", type=int, default=150, help="rounds of the multi-job stop")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    K, k, T, dev = args.K, args.k, args.T, args.device

    print(f"== selector x scenario grid (K={K}, k={k}, T={T}) ==")
    rows = run_grid(("e3cs", "random", "fedcs"), SCENARIOS, K=K, k=k, T=T, seed=0, device=dev)
    print(format_grid(rows))

    print("\n== scenario axis on the batched multi-job engine ==")
    mj = run_grid_multi_job(SCENARIOS, K=K, k=k, T=args.T_multi, seed=0, device=dev)
    print(format_grid(mj))

    print("\n== bit-packed replay ==")
    vol, rho = make_scenario("regional_outage", K, T, seed=0, device=dev)
    packed = record_trace(vol, T, seed=0, device=dev)
    dense = unpack_trace(packed, K)
    a = scan_selection_sim("e3cs", K=K, k=k, T=T, frac=0.5, rho=rho, packed_override=packed, device=dev)
    b = scan_selection_sim("e3cs", K=K, k=k, T=T, frac=0.5, rho=rho, xs_override=dense, device=dev)
    same = bool(np.array_equal(a["masks"], b["masks"]))
    cep = float(a["masks"].ravel() @ a["xs"].ravel())
    print(f"trace: {packed.nbytes / 1e3:.1f} KB packed vs {dense.nbytes / 1e3:.1f} KB dense (32x)")
    print(f"selections bit-identical to dense replay: {same}")
    print(f"CEP on the frozen trace: {cep:.0f} / {T * k}")
    return {"grid": rows, "multi_job": mj, "packed_same_as_dense": same, "packed_bytes": int(packed.nbytes),
            "dense_bytes": int(dense.nbytes), "cep": cep}


if __name__ == "__main__":
    main()

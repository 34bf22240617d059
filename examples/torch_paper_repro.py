"""End-to-end paper reproduction on the PyTorch/CUDA port
(``examples/paper_repro.py``'s two phases).

Phase 1 (fast, exact): the numerical experiments: Fig. 3 selection
distributions, Fig. 4 CEP order, the Theorem 1 regret check.

Phase 2 (real training): EMNIST-like non-iid FL comparing E3CS-0 / E3CS-inc /
FedCS / Random with ``FLServer``: CEP accelerates early convergence,
fairness decides final accuracy.

    PYTHONPATH=src python examples/torch_paper_repro.py [--rounds 60] [--full]   # on the card
    PYTHONPATH=src python examples/torch_paper_repro.py --rounds 6 --device cpu
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.fairness import jain_index
from repro_torch.core.selection import regret, theorem1_bound, theorem1_eta
from repro_torch.core.sim import selection_sim

SCHEMES = [
    ("FedCS", dict(scheme="fedcs")),
    ("E3CS-0", dict(scheme="e3cs", frac=0.0)),
    ("E3CS-0.5", dict(scheme="e3cs", frac=0.5)),
    ("E3CS-0.8", dict(scheme="e3cs", frac=0.8)),
    ("E3CS-inc", dict(scheme="e3cs", quota="inc")),
    ("Random", dict(scheme="random")),
    ("pow-d", dict(scheme="pow_d")),
]


def phase1(T=1000, device="cuda", theorem_T=500) -> dict:
    print(f"== Phase 1: selection dynamics over {T} rounds (K=100, k=20) ==")
    rows = []
    for name, kw in SCHEMES:
        sim = selection_sim(T=T, device=device, **kw)
        cep = float((sim["masks"] * sim["xs"]).sum())
        jain = float(jain_index(torch.as_tensor(sim["counts"])))
        by_class = sim["counts"].reshape(4, -1).sum(1).astype(int).tolist()
        rows.append((name, cep, jain, by_class))
        print(f"  {name:10s} CEP={cep:7.0f}  Jain={jain:.3f}  class-counts={by_class}")
    order = [r[0] for r in sorted(rows, key=lambda r: -r[1])]
    print("  CEP order:", " > ".join(order), "(paper Fig.4: FedCS > E3CS-0 > 0.5 > 0.8 ~ inc > Random > pow-d)")

    # Theorem 1
    K, k = 50, 10
    sigmas = np.zeros(theorem_T)
    eta = theorem1_eta(K, k, sigmas)
    sim = selection_sim("e3cs", K=K, k=k, T=theorem_T, frac=0.0, eta=eta, seed=1, device=device)
    R = regret(sim["ps"], sim["xs"], k, sigmas, "static")
    bound = theorem1_bound(K, k, sigmas, eta)
    print(f"  Theorem 1: empirical regret {R:.1f} <= bound {bound:.1f}")
    return {"rows": rows, "order": order, "eta": eta, "regret": R, "bound": bound}


def phase2(rounds=60, device="cuda", K=100, k=20, samples_per_client=60) -> dict:
    print(f"== Phase 2: real FL training ({rounds} rounds, non-iid EMNIST-like) ==")
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.data import ClientStore, make_image_dataset, partition_primary_label
    from repro_torch.device import resolve_device
    from repro_torch.fl import FLServer
    from repro_torch.models import build_model, cross_entropy

    dev = resolve_device(device)
    data = make_image_dataset(26, (28, 28, 1), 4000, 1500, seed=0)
    shards = partition_primary_label(data["y"], K, samples_per_client, seed=0)
    store = ClientStore(data, shards)
    model = build_model(get_config("emnist-cnn"))
    x, y = store.eval_batch(1000)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    def eval_fn(params):
        with torch.no_grad():
            logits = model.forward(params, {"x": x, "y": y})
        return float(torch.mean((torch.argmax(logits, -1) == y).to(torch.float32))), float(cross_entropy(logits, y))

    results = {}
    for name, kw in [
        ("E3CS-0", dict(scheme="e3cs", quota="const", quota_frac=0.0)),
        ("E3CS-inc", dict(scheme="e3cs", quota="inc")),
        ("FedCS", dict(scheme="fedcs")),
        ("Random", dict(scheme="random")),
    ]:
        fl = FLConfig(K=K, k=k, rounds=rounds, samples_per_client=samples_per_client, batch_size=20,
                      local_epochs=(1, 2), seed=0, **kw)
        srv = FLServer(model, fl, store, eval_fn, device=dev)
        state = srv.init_state(prng.PRNGKey(0, dev))
        state, hist = srv.run(state, eval_every=max(2, rounds // 10))
        results[name] = dict(acc=hist["acc"], cep=float(state.cep))
        print(f"  {name:10s} CEP={int(state.cep):4d}  acc@mid={hist['acc'][len(hist['acc']) // 2]:.3f}  "
              f"final={hist['acc'][-1]:.3f}")
    print(json.dumps({n: dict(final=v["acc"][-1], cep=v["cep"]) for n, v in results.items()}, indent=1))
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--full", action="store_true", help="paper-scale horizons (hours on CPU)")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    p1 = phase1(T=2500 if args.full else 1000, device=args.device)
    p2 = phase2(rounds=400 if args.full else args.rounds, device=args.device)
    return {"phase1": p1, "phase2": p2}


if __name__ == "__main__":
    main()
